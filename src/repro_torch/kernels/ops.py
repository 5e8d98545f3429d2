"""Step functions around the kernels, in the real single-matrix forms.

``level_update_body`` consumes the host-precomputed (D, R, C) segmented
layout of one level (built once per plan in ``TorchFactorizer``): the
normalisation and the operand gathers are plain PyTorch, K1 accumulates the
contributions per destination column, and the updated segments are written
back (segments are disjoint, so the write is race-free).

The factorizer's value array carries one trash slot past the real values
(``vals[nnz]``): every padded index of the K1 layout points there, so padded
reads and writes stay inside the trash slot, and K1 drops padded positions
itself.  Scatter-adds outside K1 run in fixed-order rounds of distinct
targets (``round_order`` / ``add_in_rounds_``).
"""
from __future__ import annotations

import numpy as np
import torch

from .level_update import segmented_accumulate
from .ref import spmv_ref

__all__ = ["level_update_body", "spmv", "factor_stats", "masked_correction",
           "round_order", "add_in_rounds_"]


def level_update_body(vals, norm_idx, norm_diag, lidx2d, uidx2d, didx_local,
                      col_positions):
    """One GLU level via K1, in place on ``vals``.

    vals:          (nnz + 1,) filled values, trash slot last
    norm_idx/diag: (Pn,)  flat normalisation indices of the level
    lidx2d/uidx2d: (D, R) value indices of each update's L and U operand
    didx_local:    (D, R) int32 position of each update inside its
                          destination segment (padded with C)
    col_positions: (D, C) flat value indices of the destination segments
                          (padded with nnz)
    """
    vals[norm_idx] = vals[norm_idx] / vals[norm_diag]
    contribs = -(vals[lidx2d] * vals[uidx2d])
    out = segmented_accumulate(vals[col_positions], contribs, didx_local)
    vals[col_positions] = out
    return vals


def round_order(idx: np.ndarray):
    """Host-side order for a fixed-order scatter-add: ``(perm, bounds)`` such
    that round ``r``, ``perm[bounds[r]:bounds[r + 1]]``, holds the r-th entry
    of every target.  Within a round the targets are distinct, and each
    target meets its entries in their original order."""
    idx = np.asarray(idx)
    n = len(idx)
    if n == 0:
        return np.zeros(0, dtype=np.int64), [0]
    order = np.argsort(idx, kind="stable")
    srt = idx[order]
    first = np.concatenate([[True], srt[1:] != srt[:-1]])
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - start
    perm = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[perm], np.arange(int(rank.max()) + 2))
    return perm, [int(b) for b in bounds]


def add_in_rounds_(dst, idx, src, bounds, alpha: float = 1.0):
    """``dst[idx] += alpha * src`` for entries in :func:`round_order`: each
    round's targets are distinct, so every ``index_add_`` is exact and the
    sum order per target is the entries' original order, on any device and
    in any run."""
    for s, e in zip(bounds[:-1], bounds[1:]):
        dst.index_add_(0, idx[s:e], src[s:e], alpha=alpha)
    return dst


# COO SpMV for refinement's residual: a row of A has many entries, so one
# sorted deterministic scatter-add beats rounds of distinct rows
spmv = spmv_ref


def factor_stats(vals, diag_idx, a_max):
    """Element pivot growth ``max|LU| / max|A|`` and the smallest factored
    diagonal magnitude, as 0-d tensors."""
    tiny = torch.finfo(vals.dtype).tiny
    growth = vals.abs().max() / torch.clamp(a_max, min=tiny)
    return growth, vals[diag_idx].abs().min()


def masked_correction(x, d, berr, tol: float):
    """``x + d`` while the solve is above tolerance, ``x`` once it has
    converged: the convergence mask stays on the device, so refinement
    sweeps need no host sync each."""
    return x + torch.where(berr > tol, d, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
