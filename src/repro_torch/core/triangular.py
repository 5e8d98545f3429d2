"""Level-scheduled sparse triangular solves (L y = b, U x = y) in PyTorch,
plus iterative refinement on the device factors.

The forward sweep reuses the factorization levels; the backward sweep uses
the U-row levels computed at plan time.  Each level is one step with its
real entries only (the JAX package pads levels to shared shapes for
``lax.scan``; eager PyTorch needs no such groups), stored in fixed-order
rounds of distinct target rows (``kernels.ops.round_order``): the
scatter-adds are exact and give the same bits on every run.

Refinement runs on whatever system the factors describe (for the GLU
facade, the scaled and permuted one): each sweep computes ``r = b - A x``
with a COO SpMV of A's values, the componentwise backward error
``max_i |r_i| / (|A||x| + |b|)_i`` as the stopping test, and, while above
tolerance, one more triangular solve.

Complex factors and right-hand sides run the same steps in PyTorch's
complex arithmetic (the scatter-adds on re/im plane views, see
``kernels.ops.add_in_rounds_``); the backward error then takes complex
magnitudes, ``|r| / (|A||x| + |b|)``, as the JAX package's planar path
does.  Sweeps run in chunks of
``sync_every`` with the convergence mask applied on the device, so the
common ``refine <= 2`` case costs one device-to-host read.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ops import add_in_rounds_, masked_correction, round_order, spmv
from .plan import FactorizePlan

__all__ = ["TorchTriangularSolver", "trisolve_numpy"]


def trisolve_numpy(plan: FactorizePlan, vals: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sequential oracle: unit-lower forward then upper backward solve."""
    n, indptr, indices = plan.n, plan.indptr, plan.indices
    vals = np.asarray(vals)
    dtype = np.result_type(vals.dtype, np.asarray(b).dtype, np.float64)
    vals = vals.astype(dtype, copy=False)
    x = np.array(b, dtype=dtype, copy=True)
    for j in range(n):
        e = int(indptr[j + 1])
        dp = int(plan.diag_idx[j])
        rows = indices[dp + 1 : e]
        x[rows] -= vals[dp + 1 : e] * x[j]
    for j in range(n - 1, -1, -1):
        s = int(indptr[j])
        dp = int(plan.diag_idx[j])
        x[j] /= vals[dp]
        rows = indices[s:dp]
        x[rows] -= vals[s:dp] * x[j]
    return x



def _fwd_level(vals, x, rows, cols, vidx, bounds):
    add_in_rounds_(x, rows, vals[vidx] * x[cols], bounds, alpha=-1.0)


def _bwd_level(vals, x, lcols, ldiag, rows, cols, vidx, bounds):
    x[lcols] = x[lcols] / vals[ldiag]
    add_in_rounds_(x, rows, vals[vidx] * x[cols], bounds, alpha=-1.0)


def _residual_berr(rows, cols, a_vals, a_abs, x, b, n: int):
    """r = b - A x and the componentwise backward error (a 0-d tensor).
    Zero denominators (a row with |A||x| + |b| == 0) count as converged
    when the residual there is zero and as inf otherwise."""
    r = b - spmv(rows, cols, a_vals, x, n)
    denom = spmv(rows, cols, a_abs, x.abs(), n) + b.abs()
    ra = r.abs()
    pos = denom > 0
    ratio = torch.where(pos, ra / torch.where(pos, denom, torch.ones_like(denom)),
                        torch.where(ra > 0, torch.full_like(ra, torch.inf),
                                    torch.zeros_like(ra)))
    return r, ratio.max()


def _read_back(berr, iters):
    """Both refinement counters in one device-to-host read."""
    b, i = torch.stack([berr, iters.to(berr.dtype)]).tolist()
    return b, int(i)


class TorchTriangularSolver:
    """solve(vals, b): forward + backward substitution on factored values,
    one step per level (eager PyTorch needs none of the JAX package's
    padded level groups)."""

    def __init__(self, plan: FactorizePlan, device=None):
        self.plan = plan
        self.device = resolve_device(device)
        # host-issued level steps of the most recent solve* call
        self.last_n_dispatches = 0
        self.fwd_levels, self.bwd_levels = self._build_schedule()

    def _build_schedule(self):
        """Per-level index tuples (device int64 tensors, entries in
        :func:`round_order` of their target rows, then the round bounds) for
        the forward and the backward sweep."""
        plan, dev = self.plan, self.device

        def level(*head, rows, cols, vidx):
            perm, bounds = round_order(rows)
            arrs = (*head, rows[perm], cols[perm], vidx[perm])
            return tuple(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                         device=dev) for a in arrs) + (bounds,)

        fwd = []
        for l in range(len(plan.fwd_ptr) - 1):
            s, e = int(plan.fwd_ptr[l]), int(plan.fwd_ptr[l + 1])
            fwd.append(level(rows=plan.fwd_rows[s:e], cols=plan.fwd_cols[s:e],
                             vidx=plan.fwd_vidx[s:e]))
        bwd = []
        for l in range(len(plan.bwd_ptr) - 1):
            s, e = int(plan.bwd_ptr[l]), int(plan.bwd_ptr[l + 1])
            cs, ce = int(plan.bwd_col_ptr[l]), int(plan.bwd_col_ptr[l + 1])
            lcols = plan.bwd_level_cols[cs:ce]
            bwd.append(level(lcols, plan.diag_idx[lcols],
                             rows=plan.bwd_rows[s:e], cols=plan.bwd_cols[s:e],
                             vidx=plan.bwd_vidx[s:e]))
        return fwd, bwd

    def solve(self, vals: torch.Tensor, b) -> torch.Tensor:
        """Solve with factored (nnz,) values; returns an (n,) tensor in the
        values' dtype on their device."""
        x = torch.as_tensor(b, dtype=vals.dtype, device=vals.device).clone()
        for lev in self.fwd_levels:
            _fwd_level(vals, x, *lev)
        for lev in self.bwd_levels:
            _bwd_level(vals, x, *lev)
        self.last_n_dispatches = len(self.fwd_levels) + len(self.bwd_levels)
        return x

    def solve_refined(self, vals, b, a_rows, a_cols, a_vals, a_abs,
                      max_iter: int, tol: float, sync_every: int = 2):
        """Solve then refine: up to ``max_iter`` sweeps of
        ``x += solve(b - A x)`` on the existing factors, stopping when the
        componentwise backward error drops to ``tol``.  ``a_rows``/
        ``a_cols``/``a_vals`` describe A in COO entry order and ``a_abs`` is
        ``|a_vals|``.  Returns ``(x, info)`` with ``refine_iters``,
        ``backward_error``, ``converged`` and ``host_syncs``."""
        n = self.plan.n
        b = torch.as_tensor(b, dtype=vals.dtype, device=vals.device)
        x = self.solve(vals, b)
        n_disp = self.last_n_dispatches + 1      # + the residual pass
        r, berr = _residual_berr(a_rows, a_cols, a_vals, a_abs, x, b, n)
        iters = torch.zeros((), dtype=torch.int64, device=vals.device)
        syncs = 0
        done = 0
        berr_h = iters_h = None
        while done < max_iter:
            chunk = min(max(1, int(sync_every)), max_iter - done)
            for _ in range(chunk):
                d = self.solve(vals, r)
                n_disp += self.last_n_dispatches + 2   # mask + residual
                x = masked_correction(x, d, berr, tol)
                iters = iters + (berr > tol)
                r, berr = _residual_berr(a_rows, a_cols, a_vals, a_abs, x, b, n)
            done += chunk
            berr_h, iters_h = _read_back(berr, iters)
            syncs += 1
            if berr_h <= tol:
                break
        if berr_h is None:                      # max_iter == 0
            berr_h, iters_h = _read_back(berr, iters)
            syncs += 1
        self.last_n_dispatches = n_disp
        return x, {"refine_iters": iters_h, "backward_error": berr_h,
                   "converged": berr_h <= tol, "host_syncs": syncs}
