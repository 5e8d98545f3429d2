"""Numeric LU factorization: host oracles and the PyTorch level-scheduled
executor.

* ``factorize_numpy``      — paper Alg. 2 (hybrid right-looking), sequential
                             host oracle, verbatim loop structure.
* ``factorize_numpy_fast`` — the same math with a CSR view of the pattern.
* ``TorchFactorizer``      — the GLU3.0 executor: level-scheduled, three
                             adaptive modes, one step per level,
                             SEGMENTED/PANEL levels through kernel K1 and the
                             dense trailing block through kernel K2.

The executor is built once from a :class:`FactorizePlan` and reused for
every refactorization with new values on the same pattern (the
Newton-Raphson inner loop of circuit simulation).

Padding: eager PyTorch needs no equal shapes, so every level is its own
step.  A flat level keeps only its real entries, stored in fixed-order
rounds of distinct destinations (``kernels.ops.round_order``), so its
scatter-add is exact and the same bits on every run.  A K1 level is laid
out as (D, R, C) with R and C the level's own largest row and segment: the
value buffer has one trash slot past the real values (``vals[nnz]``), every
padded index of that layout is ``nnz``, and padded reads feed only padded
writes into the trash slot, whose value is never read into a real slot.
The dense tail is padded to a multiple of K2's block; it gathers and
scatters through explicit lists of its real positions, so its non-pattern
entries read exact zeros.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.dense_lu import BLOCK, dense_lu
from ..kernels.ops import add_in_rounds_, level_update_body, round_order
from ..sparse.csc import csc_transpose_pattern
from .plan import MODE_PANEL, MODE_SEGMENTED, FactorizePlan
from .symbolic import FilledPattern

__all__ = ["factorize_numpy", "factorize_numpy_fast", "TorchFactorizer",
           "split_lu", "value_dtype"]


# --------------------------------------------------------------------------
# Host oracles (verbatim paper algorithms)
# --------------------------------------------------------------------------

def _oracle_dtype(vals) -> np.dtype:
    """Working dtype of the host oracles: the input's dtype promoted to at
    least 64-bit precision."""
    return np.result_type(np.asarray(vals).dtype, np.float64)


def factorize_numpy(As: FilledPattern, vals: np.ndarray) -> np.ndarray:
    """Paper Algorithm 2: hybrid column right-looking LU (sequential oracle)."""
    n, indptr, indices = As.n, As.indptr, As.indices
    vals = np.array(vals, dtype=_oracle_dtype(vals), copy=True)
    for j in range(n):
        s, e = int(indptr[j]), int(indptr[j + 1])
        rows = indices[s:e]
        dp = s + int(np.searchsorted(rows, j))
        diag = vals[dp]
        # compute column j of L
        vals[dp + 1 : e] /= diag
        # update the submatrix: for k > j with As(j, k) != 0
        lrows = rows[dp + 1 - s :]
        lvals = vals[dp + 1 : e]
        if len(lrows) == 0:
            continue
        for k in range(j + 1, n):
            ks, ke = int(indptr[k]), int(indptr[k + 1])
            p = ks + int(np.searchsorted(indices[ks:ke], j))
            if p < ke and indices[p] == j:
                ujk = vals[p]
                pos = ks + np.searchsorted(indices[ks:ke], lrows)
                vals[pos] -= lvals * ujk
    return vals


def factorize_numpy_fast(As: FilledPattern, vals: np.ndarray) -> np.ndarray:
    """Same math as :func:`factorize_numpy`, using a CSR view to find the
    subcolumns of j directly (used by larger tests)."""
    n, indptr, indices = As.n, As.indptr, As.indices
    indptr_t, indices_t, pos_t = csc_transpose_pattern(n, indptr, indices)
    vals = np.array(vals, dtype=_oracle_dtype(vals), copy=True)
    for j in range(n):
        s, e = int(indptr[j]), int(indptr[j + 1])
        rows = indices[s:e]
        dp = s + int(np.searchsorted(rows, j))
        vals[dp + 1 : e] /= vals[dp]
        lrows = rows[dp + 1 - s :]
        lvals = vals[dp + 1 : e]
        if len(lrows) == 0:
            continue
        ts, te = int(indptr_t[j]), int(indptr_t[j + 1])
        krange = indices_t[ts:te]
        kpos = pos_t[ts:te]
        right = krange > j
        for k, up in zip(krange[right], kpos[right]):
            ks, ke = int(indptr[k]), int(indptr[k + 1])
            pos = ks + np.searchsorted(indices[ks:ke], lrows)
            vals[pos] -= lvals * vals[up]
    return vals


def split_lu(As: FilledPattern, vals: np.ndarray):
    """Split factorized values into scipy L (unit diag) and U matrices."""
    import scipy.sparse as sp

    n, indptr, indices = As.n, As.indptr, As.indices
    vals = np.asarray(vals)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    lower = indices > cols
    upper = ~lower
    L = sp.coo_matrix((vals[lower], (indices[lower], cols[lower])), shape=(n, n)).tocsc()
    L = L + sp.eye(n, format="csc")
    U = sp.coo_matrix((vals[upper], (indices[upper], cols[upper])), shape=(n, n)).tocsc()
    return L, U


# --------------------------------------------------------------------------
# Plan-time layouts (host numpy)
# --------------------------------------------------------------------------

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def value_dtype(dtype) -> torch.dtype:
    """A torch value dtype from a torch or numpy spelling.  The port runs
    real float32 and float64 only; complex values are a later slice."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_complex:
            raise NotImplementedError("complex dtypes are not ported yet")
        if dtype in (torch.float32, torch.float64):
            return dtype
        raise TypeError(f"unsupported value dtype {dtype}")
    nd = np.dtype(dtype)
    if np.issubdtype(nd, np.complexfloating):
        raise NotImplementedError("complex dtypes are not ported yet")
    if nd not in _TORCH_DTYPES:
        raise TypeError(f"unsupported value dtype {nd}")
    return _TORCH_DTYPES[nd]


def _build_pallas_layout(plan: FactorizePlan, seg, pad_key: int):
    """Host-side (D, R, C) segmented layout for one level (see kernels/ops):
    (norm_idx, norm_diag, lidx2d, uidx2d, didx_local, col_positions).  R is
    the level's most updates into one destination column and C its longest
    destination column; shorter rows are padded (``pad_key``, and C in
    ``didx_local``)."""
    us = seg.upd_slice
    dst = plan.dst_col[us]
    li, ui, di = plan.lidx[us], plan.uidx[us], plan.didx[us]
    uniq, starts = np.unique(dst, return_index=True)
    starts = np.append(starts, len(dst))
    counts = np.diff(starts)
    D = len(uniq)
    R = int(counts.max())
    col_start = plan.indptr[uniq].astype(np.int64)
    col_len = (plan.indptr[uniq + 1] - plan.indptr[uniq]).astype(np.int64)
    C = int(col_len.max())

    lidx2d = np.full((D, R), pad_key, dtype=np.int32)
    uidx2d = np.full((D, R), pad_key, dtype=np.int32)
    didx_local = np.full((D, R), C, dtype=np.int32)
    for r in range(D):
        s, e = starts[r], starts[r + 1]
        m = e - s
        lidx2d[r, :m] = li[s:e]
        uidx2d[r, :m] = ui[s:e]
        didx_local[r, :m] = di[s:e] - col_start[r]
    pos = col_start[:, None] + np.arange(C)[None, :]
    pos = np.where(np.arange(C)[None, :] < col_len[:, None], pos, pad_key)
    ns = seg.norm_slice
    return (
        plan.norm_idx[ns],
        plan.norm_diag[ns],
        lidx2d,
        uidx2d,
        didx_local,
        pos.astype(np.int32),
    )


def _find_dense_tail(plan: FactorizePlan, min_size: int = 64,
                     max_size: int = 1024, density: float = 0.25):
    """Beyond-paper switch-to-dense: find a level suffix whose columns form a
    trailing [c*, n) block dense enough to finish with one blocked dense LU.
    Returns (level_cut, c_star) or None.

    Correctness: dependencies only point forward, updates from column j only
    write rows in L(j) (all >= c* when j >= c*), and the filled pattern is
    elimination-closed — so the dense block factorization is exact and
    entries outside the pattern stay identically zero.
    """
    n = plan.n
    nlev = plan.num_levels
    if nlev < 4:
        return None
    lo, hi = max(n - max_size, 1), n - min_size
    if hi < lo:
        return None
    levels = plan.levels.levels.astype(np.int64)
    # clean column partition: columns [0,c) must all be in levels < l* and
    # columns [c,n) all in levels >= l* — otherwise a tail column would be
    # factorized twice (once sparsely, once densely)
    pmax = np.concatenate([[-1], np.maximum.accumulate(levels)])   # pmax[c]
    smin = np.minimum.accumulate(levels[::-1])[::-1]               # smin[c]
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(plan.indptr))
    # entries inside the trailing [c, n) block are exactly those with
    # min(row, col) >= c: one histogram + suffix-sum covers every candidate
    m = np.minimum(cols, plan.indices.astype(np.int64))
    suffix = np.cumsum(np.bincount(m, minlength=n + 1)[::-1])[::-1]
    c = np.arange(lo, hi + 1, dtype=np.int64)
    size = n - c
    ok = (pmax[c] < smin[c]) & (suffix[c] / (size * size) >= density)
    idx = np.flatnonzero(ok)
    if not idx.size:
        return None
    c_star = int(c[idx[0]])    # smallest cut = largest qualifying tail
    return int(smin[c_star]), int(c_star)


def _build_dense_tail(plan: FactorizePlan, c_star: int):
    """Real positions of the trailing block: (value indices, flat positions
    in the row-major (Np, Np) tile, flat positions of the padded diagonal,
    Np).  Np is the block size rounded up to a multiple of K2's ``BLOCK``."""
    n = plan.n
    size = n - c_star
    Np = -(-size // BLOCK) * BLOCK
    vidx, flat = [], []
    for j in range(c_star, n):
        s, e = int(plan.indptr[j]), int(plan.indptr[j + 1])
        rows = plan.indices[s:e].astype(np.int64)
        m = rows >= c_star
        vidx.append(np.arange(s, e, dtype=np.int64)[m])
        flat.append((rows[m] - c_star) * Np + (j - c_star))
    ii = np.arange(size, Np, dtype=np.int64)
    return np.concatenate(vidx), np.concatenate(flat), ii * (Np + 1), Np


@dataclasses.dataclass
class _Group:
    """One executor step: a single level ("flat"), a K1-segmented level
    ("pallas", the JAX package's name for the kind) or the dense trailing
    block ("dense")."""

    kind: str      # "flat" | "pallas" | "dense"
    arrays: tuple  # device tensors (flat: with the level's round bounds)


# --------------------------------------------------------------------------
# Step functions
# --------------------------------------------------------------------------

def _level_step(vals, norm_idx, norm_diag, lidx, uidx, didx, bounds):
    """One flat level: normalise its L parts, then
    ``vals[didx] -= vals[lidx] * vals[uidx]`` in fixed-order rounds (the
    triples are stored in :func:`round_order` of ``didx``)."""
    vals[norm_idx] = vals[norm_idx] / vals[norm_diag]
    add_in_rounds_(vals, didx, vals[lidx] * vals[uidx], bounds, alpha=-1.0)


def _dense_tail_step(vals, tail_vidx, tail_flat, eye_flat, Np: int):
    """Gather the trailing block into a dense tile (exact zeros off the
    pattern, ones on the padded diagonal), factor it with K2, scatter the
    real positions back."""
    dense = torch.zeros(Np * Np, dtype=vals.dtype, device=vals.device)
    dense[tail_flat] = vals[tail_vidx]
    dense[eye_flat] = 1.0
    lu = dense_lu(dense.view(Np, Np))
    vals[tail_vidx] = lu.view(-1)[tail_flat]
    return vals


class TorchFactorizer:
    """Level-scheduled GLU3.0 numeric factorization on one device.

    Parameters
    ----------
    plan: FactorizePlan
    dtype: torch.float32 or torch.float64 (numpy spellings accepted)
    device: ``None`` (the card; raises when there is none), ``"cuda"`` or
        ``"cpu"``.  On the card SEGMENTED/PANEL levels launch K1 and the
        dense tail K2; on the CPU the same steps run the plain versions.
    dense_tail / dense_tail_density: switch-to-dense for a dense-enough
        trailing column block, as in the JAX package.

    Every level before the dense tail is one step, where the JAX package
    fuses runs of equal padded shapes into scan groups: eager PyTorch issues
    each level's operations separately either way.  ``kinds`` lists the
    steps, ``n_groups`` counts them, and ``last_n_dispatches`` is the number
    of host-issued steps of the latest factorization (the entry scatter plus
    one per step).
    """

    def __init__(
        self,
        plan: FactorizePlan,
        dtype=torch.float64,
        device=None,
        dense_tail: bool = True,
        dense_tail_density: float = 0.25,
    ):
        self.plan = plan
        self.device = resolve_device(device)
        self.dtype = value_dtype(dtype)
        self.kernels_disabled_reason = (
            None if self.device.type == "cuda" else
            "device='cpu' runs the plain PyTorch versions of the kernels")
        self.nnz = plan.nnz
        dev = self.device

        def idx(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self._a_scatter = idx(plan.a_scatter)
        self._diag_idx = idx(plan.diag_idx)

        pad_key = plan.nnz   # K1 padding index == nnz: the trash slot
        self.dense_tail_info = None
        level_cut = plan.num_levels
        if dense_tail:
            found = _find_dense_tail(plan, density=dense_tail_density)
            if found is not None:
                level_cut, c_star = found
                tv, tf, ef, Np = _build_dense_tail(plan, c_star)
                self.dense_tail_info = dict(level_cut=level_cut, c_star=c_star,
                                            size=plan.n - c_star, padded=Np)
                self._dense_tail = (idx(tv), idx(tf), idx(ef), Np)

        groups: list[_Group] = []
        for seg in plan.segments:
            if seg.level >= level_cut:
                break  # replaced by the dense trailing block
            if seg.mode in (MODE_SEGMENTED, MODE_PANEL) and seg.n_upd:
                ni, nd, li, ui, dl, cp = _build_pallas_layout(plan, seg, pad_key)
                groups.append(_Group("pallas", (
                    idx(ni), idx(nd), idx(li), idx(ui), idx(dl, torch.int32),
                    idx(cp))))
                continue
            ns, us = seg.norm_slice, seg.upd_slice
            perm, bounds = round_order(plan.didx[us])
            groups.append(_Group("flat", (
                idx(plan.norm_idx[ns]), idx(plan.norm_diag[ns]),
                idx(plan.lidx[us][perm]), idx(plan.uidx[us][perm]),
                idx(plan.didx[us][perm]), bounds)))
        if self.dense_tail_info is not None:
            groups.append(_Group(kind="dense", arrays=self._dense_tail))
        self._groups = groups
        self._kinds = tuple(g.kind for g in groups)
        self.n_groups = len(groups)
        self.last_n_dispatches = 0

    @property
    def kinds(self) -> tuple:
        """The schedule's group kinds in order."""
        return self._kinds

    def factorize(self, a_vals) -> torch.Tensor:
        """Scatter A values (the plan's A entry order) into the filled
        pattern and factorize; returns the (nnz,) factored values."""
        a = torch.as_tensor(a_vals, dtype=self.dtype, device=self.device)
        vals = torch.zeros(self.nnz + 1, dtype=self.dtype, device=self.device)
        vals[self._a_scatter] = a
        return self._run(vals)

    def factorize_filled(self, vals) -> torch.Tensor:
        """Factorize an already-filled (nnz,) value array (not modified)."""
        buf = torch.zeros(self.nnz + 1, dtype=self.dtype, device=self.device)
        buf[: self.nnz] = torch.as_tensor(vals, dtype=self.dtype,
                                          device=self.device)
        return self._run(buf)

    def _run(self, vals) -> torch.Tensor:
        for g in self._groups:
            if g.kind == "pallas":
                level_update_body(vals, *g.arrays)
            elif g.kind == "dense":
                _dense_tail_step(vals, *g.arrays)
            else:
                _level_step(vals, *g.arrays)
        self.last_n_dispatches = 1 + len(self._groups)
        return vals[: self.nnz]

    __call__ = factorize
