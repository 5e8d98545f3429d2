"""GLU facade, single matrix: the paper's full flow behind one class.

  A -> MC64 (max-product matching + Dr/Dc scaling) -> fill-reducing
  ordering -> symbolic fill-in -> relaxed dependency detection +
  levelization -> plan -> (re)factorize on the device -> triangular solve
  (+ optional iterative refinement)

Host planning is numpy (:mod:`.planner`, through its content-addressed
plan cache); ``factorize``/``solve`` are the fast repeated path.  The
numeric phase runs on the card by default: SEGMENTED/PANEL levels through
kernel K1, the dense trailing block through kernel K2.  ``device="cpu"``
runs the same schedule with the kernels' plain PyTorch versions.

Permutation algebra: with row_map/col_map (old -> new),
``A_perm[row_map[i], col_map[j]] = A[i, j]``; solving ``A x = b`` becomes
``A_perm x_perm = b_perm`` with ``b_perm = b[inv_row_map]`` and
``x = x_perm[col_map]``.

Scaling algebra: the device factorizes ``B = Dr A Dc``; ``A x = b`` becomes
``B y = Dr b`` with ``x = Dc y``.  The componentwise backward error is
invariant under both scalings, so refinement's stopping test on the scaled
system is the same test on the original one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..sparse.csc import CSC
from .factorize import TorchFactorizer, value_dtype
from .planner import MC64Scaling, SymbolicPlan, compute_scaling, plan_factorization
from .triangular import TorchTriangularSolver

__all__ = ["GLU", "resolve_value_dtype"]


def resolve_value_dtype(dtype, device) -> torch.dtype:
    """The value dtype the device will really hold.  A request that would
    come back narrower (a float64 request held as float32) raises instead
    of degrading in silence."""
    requested = value_dtype(dtype)
    effective = torch.empty(0, dtype=requested, device=device).dtype
    if effective != requested:
        raise ValueError(f"requested value dtype {requested} would be held as "
                         f"{effective} on {device}; request {effective} "
                         f"explicitly")
    return requested


def _not_ported(name: str, value, default) -> None:
    if value != default:
        raise NotImplementedError(
            f"{name}={value!r} is not ported to the PyTorch package yet")


class GLU:
    """Refactorize-and-solve on one sparsity pattern.

    ``device``: ``None`` runs on the card (and raises when there is none),
    ``"cpu"`` runs the plain PyTorch versions of the kernels.  The options
    ``static_pivot``, ``layout="planar"``, ``mesh``, ``jit_schedule=False``
    and ``verify`` other than ``"off"``, complex dtypes, ``rhs_pattern`` and
    the batched and many-right-hand-side methods are not ported yet and
    raise ``NotImplementedError``.  The JAX package's level-fusion options
    (``fuse_levels``, ``fuse_buckets``, ``bucket_waste``) have no
    counterpart: every level is its own step here.  The other options mean
    what they mean in the JAX package's ``GLU``.
    """

    def __init__(
        self,
        A: CSC,
        ordering: str = "auto",
        symbolic: str = "auto",
        dtype=torch.float64,
        mc64="scale",
        jit_schedule: bool = True,
        panel_threshold: int = 16,
        static_pivot: Optional[float] = None,
        refine: int = 0,
        refine_tol: Optional[float] = None,
        dense_tail: bool = True,
        dense_tail_density: float = 0.25,
        plan_cache="default",
        layout: str = "auto",
        mesh=None,
        verify: str = "off",
        device=None,
    ):
        _check_slice(dtype, jit_schedule, static_pivot, layout, mesh, verify)
        plan, scaling, from_cache = plan_factorization(
            A, ordering=ordering, symbolic=symbolic, mc64=mc64,
            panel_threshold=panel_threshold, cache=plan_cache)
        self._setup(plan, scaling, A, from_cache=from_cache, dtype=dtype,
                    refine=refine,
                    refine_tol=refine_tol, dense_tail=dense_tail,
                    dense_tail_density=dense_tail_density, device=device)

    @classmethod
    def from_plan(
        cls,
        plan: SymbolicPlan,
        A: CSC,
        dtype=torch.float64,
        mc64="scale",
        jit_schedule: bool = True,
        static_pivot: Optional[float] = None,
        refine: int = 0,
        refine_tol: Optional[float] = None,
        dense_tail: bool = True,
        dense_tail_density: float = 0.25,
        layout: str = "auto",
        mesh=None,
        verify: str = "off",
        device=None,
    ) -> "GLU":
        """Build a GLU around a prebuilt :class:`SymbolicPlan`, skipping all
        symbolic work.  ``A`` must carry the plan's pattern, and the MC64
        matching of its values must reproduce ``plan.row_perm``; raises
        ``ValueError`` otherwise."""
        _check_slice(dtype, jit_schedule, static_pivot, layout, mesh, verify)
        if not plan.matches_pattern(A):
            raise ValueError("matrix pattern differs from the plan's pattern")
        scaling = compute_scaling(A, mc64)
        if not np.array_equal(scaling.row_perm, plan.row_perm):
            raise ValueError(
                "MC64 matching of these values differs from the plan's "
                "row permutation; rebuild the plan (e.g. GLU(A, ...))")
        self = cls.__new__(cls)
        self._setup(plan, scaling, A, from_cache=True, dtype=dtype,
                    refine=refine,
                    refine_tol=refine_tol, dense_tail=dense_tail,
                    dense_tail_density=dense_tail_density, device=device)
        return self

    def _setup(self, plan: SymbolicPlan, scaling: MC64Scaling, A: CSC,
               from_cache: bool, dtype, refine: int,
               refine_tol: Optional[float],
               dense_tail: bool, dense_tail_density: float, device) -> None:
        self.device = resolve_device(device)
        self.dtype = resolve_value_dtype(dtype, self.device)
        self.n = A.n
        self.symbolic_plan = plan
        self.plan_from_cache = bool(from_cache)
        self._A_scipy = A.to_scipy()
        rows0 = np.asarray(A.indices, dtype=np.int64)
        cols0 = np.repeat(np.arange(A.n, dtype=np.int64), np.diff(A.indptr))
        self.Dr, self.Dc = scaling.Dr, scaling.Dc
        # per-original-entry scale factor: entry (i, j) -> Dr[i] * Dc[j]
        self._scale_data = self.Dr[rows0] * self.Dc[cols0]
        self._scale_identity = bool(np.all(self._scale_data == 1.0))
        self.row_map = plan.row_map
        self.col_map = plan.col_map
        self._inv_row = plan.inv_row
        self._data_perm = plan.data_perm
        scaled = np.asarray(A.data) * self._scale_data
        self._A_perm = CSC(A.n, plan.perm_indptr, plan.perm_indices,
                           scaled[self._data_perm])
        dev = self.device
        # scaled-A COO layout (permuted pattern) for refinement's SpMV
        self._spmv_rows = torch.as_tensor(plan.spmv_rows, dtype=torch.int64,
                                          device=dev)
        self._spmv_cols = torch.as_tensor(plan.spmv_cols, dtype=torch.int64,
                                          device=dev)
        self.pattern = plan.pattern
        self.levelization = plan.levelization
        self.plan = plan.fplan
        self._factorizer = TorchFactorizer(
            self.plan, dtype=self.dtype, device=dev, dense_tail=dense_tail, dense_tail_density=dense_tail_density)
        self._solver = TorchTriangularSolver(self.plan, device=dev)
        self._vals: Optional[torch.Tensor] = None
        self._a_vals: Optional[torch.Tensor] = None
        self._a_abs: Optional[torch.Tensor] = None
        self.refine_default = int(refine)
        self.refine_tol = (float(refine_tol) if refine_tol is not None
                           else 4.0 * float(torch.finfo(self.dtype).eps))
        self._info: Optional[dict] = None
        self._stats_pending = False

    # -- numeric phase (repeatable) -----------------------------------------
    def factorize(self, a_data=None) -> "GLU":
        """(Re)factorize; ``a_data`` are new values in A's original CSC entry
        order (same pattern: the SPICE refactorization contract)."""
        if a_data is None:
            data = np.asarray(self._A_perm.data)
        elif self._scale_identity:
            data = np.asarray(a_data)[self._data_perm]
        else:
            data = (np.asarray(a_data) * self._scale_data)[self._data_perm]
        self._a_vals = torch.as_tensor(data, dtype=self.dtype, device=self.device)
        self._a_abs = None                     # built on the first refined solve
        self._vals = self._factorizer.factorize(self._a_vals)
        self._stats_pending = True
        self._info = self._base_info()
        self._info["n_dispatches"] = self._factorizer.last_n_dispatches
        return self

    def factorized_values(self) -> torch.Tensor:
        """Factored (nnz,) values in the plan's filled pattern."""
        if self._vals is None:
            raise RuntimeError("call factorize() first")
        return self._vals

    def solve(self, b, refine: Optional[int] = None,
              rhs_pattern=None) -> np.ndarray:
        """Solve A x = b with the current factorization; ``refine`` extra
        iterative-refinement sweeps reuse the device factors (default: the
        constructor's ``refine``)."""
        _not_ported("rhs_pattern", rhs_pattern, None)
        if self._vals is None:
            self.factorize()
        k = self.refine_default if refine is None else int(refine)
        bp = (np.asarray(b) * self.Dr)[self._inv_row]
        if k > 0:
            if self._a_abs is None:
                self._a_abs = self._a_vals.abs()
            xp, rinfo = self._solver.solve_refined(
                self._vals, bp, self._spmv_rows, self._spmv_cols,
                self._a_vals, self._a_abs, max_iter=k, tol=self.refine_tol)
        else:
            xp = self._solver.solve(self._vals, bp)
            rinfo = {"refine_iters": 0, "backward_error": None,
                     "converged": None, "host_syncs": 0}
        if self._info is None:
            self._info = self._base_info()
        self._info.update(rinfo)
        self._info["solve_dispatches"] = self._solver.last_n_dispatches
        return xp.cpu().numpy()[self.col_map] * self.Dc

    def _base_info(self) -> dict:
        return {"batched": False, "pivot_growth": None, "min_diag": None,
                "n_perturbed": None, "refine_iters": None,
                "backward_error": None, "converged": None,
                "n_groups": self._factorizer.n_groups, "n_dispatches": None,
                "solve_dispatches": None, "layout": "native",
                "kernels_disabled_reason":
                    self._factorizer.kernels_disabled_reason,
                "n_devices": 1, "batch_spec": None,
                "n_perturbed_global": None, "verify_report": None}

    # -- out of this slice -----------------------------------------------------
    def _batched_not_ported(self, *args, **kwargs):
        raise NotImplementedError(
            "the batched and many-right-hand-side methods are not ported to "
            "the PyTorch package yet")

    factorize_batched = solve_batched = solve_multi = _batched_not_ported
    refactorize_solve = factorized_values_batched = _batched_not_ported

    # -- diagnostics ----------------------------------------------------------
    @property
    def solve_info(self) -> Optional[dict]:
        """Robustness report of the latest factorize/solve, with the JAX
        package's keys for this path (``pallas_disabled_reason`` is
        ``kernels_disabled_reason`` here: None when K1 and K2 ran on the
        card).  ``n_dispatches``/``solve_dispatches`` count host-issued
        steps."""
        if self._info is None:
            return None
        if self._stats_pending:
            from ..kernels.ops import factor_stats

            a_max = self._a_vals.abs().max()
            growth, min_diag = factor_stats(self._vals,
                                            self._factorizer._diag_idx, a_max)
            self._info.update(pivot_growth=growth.item(),
                              min_diag=min_diag.item())
            self._stats_pending = False
        return dict(self._info)

    @property
    def nnz_filled(self) -> int:
        return self.pattern.nnz

    @property
    def num_levels(self) -> int:
        return self.levelization.num_levels

    def residual(self, b, x) -> float:
        """||Ax - b||_inf / ||b||_inf on the original system."""
        r = self._A_scipy @ np.asarray(x) - np.asarray(b)
        return float(np.abs(r).max() / (np.abs(b).max() + 1e-300))


def _check_slice(dtype, jit_schedule, static_pivot, layout, mesh, verify):
    value_dtype(dtype)               # complex raises NotImplementedError
    _not_ported("jit_schedule", jit_schedule, True)
    _not_ported("static_pivot", static_pivot, None)
    if layout not in ("auto", "native"):
        _not_ported("layout", layout, "native")
    _not_ported("mesh", mesh, None)
    _not_ported("verify", verify, "off")
