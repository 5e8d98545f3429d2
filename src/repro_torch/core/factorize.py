"""Numeric LU factorization: host oracles and the PyTorch level-scheduled
executor.

* ``factorize_numpy``      — paper Alg. 2 (hybrid right-looking), sequential
                             host oracle, verbatim loop structure.
* ``factorize_numpy_fast`` — the same math with a CSR view of the pattern.
* ``leftlooking_numpy``    — paper Alg. 1 (Gilbert-Peierls left-looking),
                             the sequential baseline.
* ``TorchFactorizer``      — the GLU3.0 executor: level-scheduled, three
                             adaptive modes; each run of consecutive
                             SEGMENTED/PANEL levels is one launch of kernel
                             K1 ``level_run``, each flat level one eager
                             step, and the dense trailing block one launch
                             of K2 (real values) or K3 (complex values, on
                             re/im planes).

The executor is built once from a :class:`FactorizePlan` and reused for
every refactorization with new values on the same pattern (the
Newton-Raphson inner loop of circuit simulation).

Padding: eager PyTorch needs no equal shapes, so no step is padded to
another's.  A flat level keeps only its real entries, stored in
fixed-order rounds of distinct destinations (``kernels.ops.round_order``),
so its scatter-add is exact and the same bits on every run.  A run of K1
levels is one packed int32 layout with no padding
(:func:`_build_run_layout`, ``kernels.level_update.LevelRun``): each
destination column is one contiguous slice of the value array.  The
per-level (D, R, C) layout of the JAX package (:func:`_build_pallas_layout`,
padded with ``nnz``, the trash slot ``vals[nnz]`` past the real values) is
kept for the plain per-level route the tests hold the run against.  The
dense tail is padded to a multiple of K2's block; it gathers and scatters
through explicit lists of its real positions, so its non-pattern entries
read exact zeros.

Complex values are a complex64/complex128 value array in either layout.
With ``layout="planar"`` flat levels run in PyTorch's complex arithmetic,
K1 runs read the complex array as interleaved re/im pairs with the planar
arithmetic (``pdiv``/``pmul``), and the dense tail runs through K3 on a
(2, Np, Np) plane tile.  With ``layout="native"`` (the JAX package's
default complex route, off its kernels) every level is a flat step in
PyTorch's complex arithmetic, as the JAX package sends its SEGMENTED and
PANEL levels through its flat path, and the dense tail still runs through
K3, the one complex tail kernel.  K3 divides by a pivot ``p`` as a product
with ``conj(p) / |p|^2``, where the JAX package's native tail uses complex
``/``: the native tail agrees with the reference to rounding, not to the
bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..distributed import ShardedBatch, psum_exact
from ..kernels.dense_lu import BLOCK, dense_lu, dense_lu_planar
from ..kernels.level_update import LevelRun, level_run
from ..kernels.ops import add_in_rounds_, perturb_diags, round_order
from ..sparse.csc import csc_transpose_pattern
from ..sparse.layout import ValueLayout, resolve_layout
from .executor import CapturedSchedule, resolve_executable_cache
from .plan import MODE_FLAT, MODE_PANEL, MODE_SEGMENTED, FactorizePlan
from .symbolic import FilledPattern

__all__ = ["factorize_numpy", "factorize_numpy_fast", "leftlooking_numpy",
           "TorchFactorizer", "split_lu", "value_dtype", "ported_layout"]


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


def leftlooking_numpy(As: FilledPattern, vals: np.ndarray) -> np.ndarray:
    """Paper Algorithm 1: Gilbert-Peierls left-looking LU (baseline)."""
    n, indptr, indices = As.n, As.indptr, As.indices
    vals = np.array(vals, dtype=_oracle_dtype(vals), copy=True)
    for j in range(n):
        s, e = int(indptr[j]), int(indptr[j + 1])
        rows = indices[s:e]
        dp = s + int(np.searchsorted(rows, j))
        # triangular solve: for k < j with As(k, j) != 0 ascending
        for p in range(s, dp):
            k = int(indices[p])
            akj = vals[p]
            ks, ke = int(indptr[k]), int(indptr[k + 1])
            kdp = ks + int(np.searchsorted(indices[ks:ke], k))
            lrows = indices[kdp + 1 : ke]
            if len(lrows) == 0:
                continue
            pos = s + np.searchsorted(rows, lrows)
            vals[pos] -= vals[kdp + 1 : ke] * akj
        vals[dp + 1 : e] /= vals[dp]
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
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.complex64): torch.complex64,
                 np.dtype(np.complex128): torch.complex128}


def value_dtype(dtype) -> torch.dtype:
    """A torch value dtype from a torch or numpy spelling: float32, float64,
    complex64 or complex128."""
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_DTYPES.values():
            return dtype
        raise TypeError(f"unsupported value dtype {dtype}")
    nd = np.dtype(dtype)
    if nd not in _TORCH_DTYPES:
        raise TypeError(f"unsupported value dtype {nd}")
    return _TORCH_DTYPES[nd]


def ported_layout(layout, dtype) -> ValueLayout:
    """The value layout of ``layout`` for ``dtype``: :func:`resolve_layout`
    (``"planar"`` on real values and unknown names raise ``ValueError`` as
    in the JAX package).  ``"native"`` with complex values is the JAX
    package's default complex route: every level a flat step, the dense
    tail on K3.  ``"auto"`` resolves to planar for complex values here,
    a deliberate difference: the JAX package's ``GLU`` resolves it to
    native when ``use_pallas`` is off (its default, ``core/api.py:263``),
    because its TPU kernels take no complex operands; this package has no
    ``use_pallas``, and its kernels take complex values."""
    return resolve_layout(layout, value_dtype(dtype))


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


def _build_run_layout(plan: FactorizePlan, segs, device,
                      diag=None) -> LevelRun:
    """The packed layout of one run of consecutive K1 levels ``segs`` (see
    ``kernels.level_update.LevelRun``): per level its normalization and
    destination-row ranges, per row (one destination column of the level)
    its segment ``vals[col_start : col_start + col_len]`` and update range,
    per update ``lidx, uidx, ldiag, dpos`` in the plan's order.  The
    levels' updates and normalization entries are contiguous in the plan,
    so the run slices them once.  ``diag`` is ``(diag_ptr, diag_idx)``,
    each level's column diagonals for static pivoting.  ``LevelRun``
    checks that every index fits
    in int32 and the invariants that make one grid barrier a level safe,
    and raises ``ValueError`` on a plan that breaks them."""
    u0, u1 = segs[0].upd_slice.start, segs[-1].upd_slice.stop
    n0, n1 = segs[0].norm_slice.start, segs[-1].norm_slice.stop
    indptr = np.asarray(plan.indptr, dtype=np.int64)
    lev = np.repeat(np.arange(len(segs)), [s.n_upd for s in segs])
    dst = plan.dst_col[u0:u1]
    # a new row wherever the level or the destination column changes
    new_row = np.ones(len(dst), dtype=bool)
    new_row[1:] = (dst[1:] != dst[:-1]) | (lev[1:] != lev[:-1])
    first = np.flatnonzero(new_row)
    row_of = np.cumsum(new_row) - 1
    col = dst[first]
    col_start = indptr[col]
    rows = np.stack([col_start, indptr[col + 1] - col_start, first,
                     np.append(first[1:], len(dst))], axis=1)
    lidx = plan.lidx[u0:u1]
    ldiag = plan.diag_idx[np.searchsorted(indptr, lidx, side="right") - 1]
    upd = np.stack([lidx, plan.uidx[u0:u1], ldiag,
                    plan.didx[u0:u1] - col_start[row_of]], axis=1)
    row_ptr = np.searchsorted(lev[first], np.arange(len(segs) + 1))
    levels = np.array([(s.norm_slice.start - n0, s.norm_slice.stop - n0,
                        row_ptr[i], row_ptr[i + 1], 0, 0)
                       for i, s in enumerate(segs)])
    norm = np.stack([plan.norm_idx[n0:n1], plan.norm_diag[n0:n1]], axis=1)
    return LevelRun(levels, rows, upd, norm, plan.nnz, device, diag=diag)


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
    """One executor step: a single level ("flat"), a run of consecutive
    K1 levels ("run", one launch) or the dense trailing block ("dense")."""

    kind: str      # "flat" | "run" | "dense"
    arrays: tuple  # flat: device tensors and the level's round bounds;
                   # run: (LevelRun,); dense: the tail's positions
    diag: Optional[torch.Tensor] = None  # flat, dense: the column diagonals
                   # static pivoting bumps first (a run carries its own)


# --------------------------------------------------------------------------
# Step functions
# --------------------------------------------------------------------------

def _level_step(vals, norm_idx, norm_diag, lidx, uidx, didx, bounds):
    """One flat level: normalise its L parts, then
    ``vals[didx] -= vals[lidx] * vals[uidx]`` in fixed-order rounds (the
    triples are stored in :func:`round_order` of ``didx``).  Real or
    complex values alike: complex ones divide and multiply in PyTorch's
    complex arithmetic.  ``vals`` is (nnz + 1,) or a batch (B, nnz + 1):
    each matrix's elementwise operations and sums are those of one matrix
    alone."""
    vals[..., norm_idx] = vals[..., norm_idx] / vals[..., norm_diag]
    add_in_rounds_(vals, didx, vals[..., lidx] * vals[..., uidx], bounds,
                   alpha=-1.0)


def _dense_tail_step(vals, tail_vidx, tail_flat, eye_flat, Np: int):
    """Gather the trailing block into a dense tile (exact zeros off the
    pattern, ones on the padded diagonal), factor it with K2, scatter the
    real positions back.  A batch (B, nnz + 1) gathers (B, Np, Np) tiles
    and factors them with one batched K2 call."""
    lead = vals.shape[:-1]
    dense = torch.zeros(lead + (Np * Np,), dtype=vals.dtype,
                        device=vals.device)
    dense[..., tail_flat] = vals[..., tail_vidx]
    dense.index_fill_(-1, eye_flat, 1.0)
    lu = dense_lu(dense.view(lead + (Np, Np)))
    vals[..., tail_vidx] = lu.view(lead + (Np * Np,))[..., tail_flat]
    return vals


def _dense_tail_step_planar(vals, tail_vidx, tail_flat, eye_flat, Np: int):
    """Complex twin of :func:`_dense_tail_step`: gather the trailing block
    into (2, Np, Np) re/im planes (exact zeros off the pattern, ``1+0j`` on
    the padded diagonal: only the real plane gets the ones), factor them
    with K3, scatter the real positions back; a batch as (B, 2, Np, Np)
    planes and one batched K3 call."""
    lead = vals.shape[:-1]
    planes = torch.zeros(lead + (2, Np * Np), dtype=vals.real.dtype,
                         device=vals.device)
    planes[..., tail_flat] = torch.view_as_real(
        vals[..., tail_vidx]).movedim(-1, -2)
    planes.select(-2, 0).index_fill_(-1, eye_flat, 1.0)
    lu = dense_lu_planar(planes.view(lead + (2, Np, Np))).view(
        lead + (2, Np * Np))
    vals[..., tail_vidx] = torch.complex(lu[..., 0, tail_flat],
                                         lu[..., 1, tail_flat])
    return vals


def _level_cut(plan: FactorizePlan, dense_tail: bool, density: float):
    """``(level_cut, c_star)``: the first level the dense tail replaces and
    its first column, or ``(num_levels, None)`` without a tail."""
    found = _find_dense_tail(plan, density=density) if dense_tail else None
    return found if found is not None else (plan.num_levels, None)


_MODES = (MODE_FLAT, MODE_SEGMENTED, MODE_PANEL)


def _schedule_kinds(plan: FactorizePlan, level_cut: int, has_tail: bool,
                    mode_override: Optional[str] = None,
                    disable_modes: tuple = (), use_k1: bool = True):
    """One kind per level in the reference's vocabulary ("flat", "pallas"),
    then "dense" for the tail.  A level's mode is ``mode_override`` or its
    plan mode; a disabled mode runs as flat, a disabled flat as segmented
    (the reference's routing, ``core/factorize.py:862-864``); SEGMENTED and
    PANEL levels with updates go to K1 unless ``use_k1`` is off (complex
    values in the native layout), which makes every level flat."""
    kinds = []
    for seg in plan.segments:
        if seg.level >= level_cut:
            break  # replaced by the dense trailing block
        mode = mode_override or seg.mode
        if mode in disable_modes:
            mode = MODE_FLAT if mode != MODE_FLAT else MODE_SEGMENTED
        kinds.append("pallas" if use_k1 and mode in (MODE_SEGMENTED,
                                                     MODE_PANEL)
                     and seg.n_upd else "flat")
    return tuple(kinds) + (("dense",) if has_tail else ())


def _native_complex(layout: ValueLayout) -> bool:
    """Complex values in the native layout: no level runs in K1."""
    return layout.dtype.is_complex and not layout.planar


def _kernels_disabled_reason(device, mode_override, disable_modes,
                             layout: ValueLayout):
    """Why K1 is off the path, as the reference's ``pallas_disabled_reason``
    (``core/factorize.py:757-777``, in its order); None when the kernels
    run."""
    if _native_complex(layout):
        return ("complex dtype with layout='native' runs every level as a "
                "flat step off K1, the dense tail on K3 (pass "
                "layout='planar' to keep K1)")
    if mode_override is not None and mode_override not in (MODE_SEGMENTED,
                                                           MODE_PANEL):
        return (f"mode_override={mode_override!r} routes every level off "
                "the K1 path")
    if MODE_SEGMENTED in disable_modes and MODE_PANEL in disable_modes:
        return "disable_modes removes every K1-eligible mode"
    if device.type != "cuda":
        return "device='cpu' runs the plain PyTorch versions of the kernels"
    return None


class _Schedule:
    """The built steps of one plan on one device: every device index
    tensor the factorization reads (the flat levels' triples in round
    order, the K1 runs' ``LevelRun`` layouts, the dense tail's position
    lists and each step's column diagonals).  Independent of the values
    and of the executor instance, so the process-wide
    :class:`~.executor.ExecutableCache` shares it between executors on one
    plan."""

    def __init__(self, plan: FactorizePlan, kinds, level_cut: int, c_star,
                 layout: ValueLayout, device):
        dev = device

        def idx(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.a_scatter = idx(plan.a_scatter)
        self.diag_idx = idx(plan.diag_idx)
        self.dense_tail_info = None
        groups: list[_Group] = []
        run: list = []

        def end_run():
            if run:
                ptr = np.cumsum([0] + [len(s.cols) for s in run])
                diag = plan.diag_idx[np.concatenate([s.cols for s in run])]
                groups.append(_Group("run", (_build_run_layout(
                    plan, run, dev, diag=(ptr, diag)),)))
                run.clear()

        for seg, kind in zip(plan.segments, kinds):
            if kind == "dense":
                break
            if kind == "pallas":
                run.append(seg)
                continue
            end_run()
            ns, us = seg.norm_slice, seg.upd_slice
            perm, bounds = round_order(plan.didx[us])
            groups.append(_Group("flat", (
                idx(plan.norm_idx[ns]), idx(plan.norm_diag[ns]),
                idx(plan.lidx[us][perm]), idx(plan.uidx[us][perm]),
                idx(plan.didx[us][perm]), bounds),
                diag=idx(plan.diag_idx[seg.cols])))
        end_run()
        if c_star is not None:
            tv, tf, ef, Np = _build_dense_tail(plan, c_star)
            self.dense_tail_info = dict(level_cut=level_cut, c_star=c_star,
                                        size=plan.n - c_star, padded=Np)
            groups.append(_Group("dense", (idx(tv), idx(tf), idx(ef), Np),
                                 diag=idx(plan.diag_idx[c_star:])))
        self.groups = groups
        self.step = {
            "flat": _level_step,
            "run": level_run,
            "dense": (_dense_tail_step_planar if layout.dtype.is_complex
                      else _dense_tail_step),
        }
        self.native = _native_complex(layout)

    def run(self, vals, tau=None, count=None) -> None:
        """Every step in order, in place on the filled value array, (nnz +
        1,) or a batch (B, nnz + 1) on the plan (with (B,) ``tau`` and
        ``count``).  With ``tau`` and ``count`` (static pivoting) each step
        first bumps its column diagonals below ``tau`` and adds the bumps
        into ``count``: a flat level and the dense tail through
        ``perturb_diags`` (native complex values by the reference's native
        rule), a K1 run inside its kernel, once per level."""
        for g in self.groups:
            if tau is None:
                self.step[g.kind](vals, *g.arrays)
            elif g.kind == "run":
                level_run(vals, *g.arrays, tau, count)
            else:
                count += perturb_diags(vals, g.diag, tau,
                                       native=self.native)[1]
                self.step[g.kind](vals, *g.arrays)


class TorchFactorizer:
    """Level-scheduled GLU3.0 numeric factorization on one device.

    Parameters
    ----------
    plan: FactorizePlan
    dtype: torch.float32, float64, complex64 or complex128 (numpy
        spellings accepted)
    device: ``None`` (the card; raises when there is none), ``"cuda"`` or
        ``"cpu"``.  On the card each run of SEGMENTED/PANEL levels is one
        launch of K1 and the dense tail one of K2 (K3 for complex values);
        on the CPU the same steps run the plain versions.
    layout: ``"auto"`` (planar for complex values, native for real ones),
        ``"planar"`` or ``"native"``.  Complex values in the native layout
        (the JAX package's default complex route) run every level as a flat
        step in PyTorch's complex arithmetic and the dense tail through K3:
        ``kinds`` is all "flat" then "dense", and
        ``kernels_disabled_reason`` names ``layout='native'``.  See
        :func:`ported_layout` for ``"auto"``.
    dense_tail / dense_tail_density: switch-to-dense for a dense-enough
        trailing column block, as in the JAX package.
    static_pivot: relative threshold eps of the static pivot guard: after
        the entry scatter ``tau = eps * max|A|`` is computed on the device,
        and each step bumps its column diagonals below ``tau`` just before
        it divides by them (a K1 run once per level, inside the kernel; the
        dense tail before K2 or K3).  Complex values keep their phase
        (``tau * d / |d|``, ``tau`` real: the reference's planar rule on
        the planar layout, its native rule in complex arithmetic on the
        native one).
        ``last_n_perturbed`` is then the bump count, a 0-d int32 device
        tensor.
    jit_schedule: on the card, the whole factorization (entry scatter,
        flat levels, K1 runs, dense tail) is one CUDA-graph replay
        (:class:`~.executor.CapturedSchedule`); ``False`` issues its steps
        one by one.  The two give the same bits.  On the CPU the steps
        always run one by one.
    executable_cache: where the built steps are cached: ``"default"`` (the
        process-wide cache), an :class:`~.executor.ExecutableCache`, or
        ``None`` (a private one).
    mode_override / disable_modes: the paper's kernel-mode ablation (Table
        III), as in the JAX package: ``mode_override`` ("flat",
        "segmented" or "panel") runs every level in that mode;
        ``disable_modes`` sends a disabled SEGMENTED or PANEL level to the
        flat step and a disabled FLAT level to a K1 run.  A level runs in
        K1 when its mode is SEGMENTED or PANEL and it has updates; the
        rest are flat steps.  ``kernels_disabled_reason`` says why K1 is
        off the path (``mode_override="flat"``, or both K1 modes
        disabled), as the reference's ``pallas_disabled_reason`` does.

    The steps, in the JAX package's order: one per flat level, one per
    maximal run of consecutive K1 levels (the counterpart of the JAX
    package's ``lax.scan`` over levels), and the dense tail.  ``kinds``
    lists one entry per level in the JAX package's vocabulary ("flat",
    "pallas", then "dense" for the tail); ``step_kinds`` lists the steps
    ("flat", "run", "dense") and ``n_groups`` counts them.
    ``last_n_dispatches`` is the number of dispatches of the latest
    factorization: 1 for a replay; when the steps run one by one (the CPU,
    ``jit_schedule=False``, and the card's first factorization, which runs
    them eagerly while it warms up the graph), the entry scatter plus one
    per step (grid64 9, rajat12_like 6).

    The factorizer owns static buffers: the A values (``a_values``) and
    the filled values.  :meth:`factorize` returns a view of the latter,
    which the next factorization overwrites.

    :meth:`factorize_batched` factorizes B matrices on the plan in
    lockstep (the JAX package's ``factorize_batched``): the same steps on
    (B, nnz + 1) values, each K1 run one launch for the whole batch, the
    dense tails one batched K2/K3 launch, the flat levels one step each;
    one replay on the card.  It owns (B, nnz_A) and (B, nnz + 1) buffers
    and a graph for the latest B; ``last_n_perturbed`` is then (B,).

    ``shard`` (a :class:`~repro_torch.distributed.ScenarioSharding`)
    splits a batched factorization whose B the shard count divides into
    contiguous row blocks, one a shard.  Each shard is a factorizer of its
    own on its device (its schedule, cached under the shard's slot
    ``shard_slot``, its buffers and its graph), and runs the whole
    schedule on its block: every shard's replay is launched before any
    host read, so distinct cards overlap.  The batch then comes back as a
    :class:`~repro_torch.distributed.ShardedBatch`, ``last_n_perturbed``
    too, ``last_n_dispatches`` counts a shard's dispatches (1 for a
    replay), ``last_shard`` is the sharding and
    ``last_n_perturbed_global`` the exact sum of every row's bumps (pad
    rows included) on the first shard's device.  Unbatched calls and
    batches that the shard count does not divide run unsharded.
    """

    def __init__(
        self,
        plan: FactorizePlan,
        dtype=torch.float64,
        device=None,
        dense_tail: bool = True,
        dense_tail_density: float = 0.25,
        layout: str = "auto",
        static_pivot: Optional[float] = None,
        jit_schedule: bool = True,
        executable_cache="default",
        mode_override: Optional[str] = None,
        disable_modes: tuple = (),
        shard=None,
        shard_slot: Optional[tuple] = None,
    ):
        if mode_override is not None and mode_override not in _MODES:
            raise ValueError(f"mode_override must be one of {_MODES} or "
                             f"None, got {mode_override!r}")
        disable_modes = tuple(disable_modes)
        if not set(disable_modes) <= set(_MODES):
            raise ValueError(f"disable_modes takes modes of {_MODES}, "
                             f"got {disable_modes!r}")
        self.plan = plan
        self.device = resolve_device(device)
        self.dtype = value_dtype(dtype)
        self.layout = ported_layout(layout, self.dtype)
        self.static_pivot = static_pivot
        self.jit_schedule = bool(jit_schedule)
        self.kernels_disabled_reason = _kernels_disabled_reason(
            self.device, mode_override, disable_modes, self.layout)
        # what twin() passes on: the same schedule key, hence the same
        # cached steps
        self._options = dict(
            dtype=self.dtype, device=self.device, dense_tail=dense_tail,
            dense_tail_density=dense_tail_density, layout=layout,
            static_pivot=static_pivot, jit_schedule=self.jit_schedule,
            mode_override=mode_override, disable_modes=disable_modes,
            shard=shard)
        self.shard = shard
        self._slot = shard_slot
        self._shards = None           # each shard's factorizer, when first used
        self._sharded_in = None       # the loaded sharded batch's inputs
        self.last_shard = None
        self.last_n_perturbed_global = None
        self.nnz = plan.nnz
        level_cut, c_star = _level_cut(plan, dense_tail, dense_tail_density)
        self._kinds = _schedule_kinds(plan, level_cut, c_star is not None,
                                      mode_override, disable_modes,
                                      use_k1=not _native_complex(self.layout))
        self._exec_cache = resolve_executable_cache(executable_cache)
        self._sched = self._exec_cache.get_or_build(
            self._schedule_key(),
            lambda: _Schedule(plan, self._kinds, level_cut, c_star,
                              self.layout, self.device))
        self.dense_tail_info = self._sched.dense_tail_info
        self.step_kinds = tuple(g.kind for g in self._sched.groups)
        self.n_groups = len(self.step_kinds)
        dev, dt = self.device, self.dtype
        self.a_values = torch.zeros(len(plan.a_scatter), dtype=dt, device=dev)
        self._buf = torch.zeros(self.nnz + 1, dtype=dt, device=dev)
        self._count = None
        if static_pivot is not None:
            # tau = eps * max|A| is real for complex values too
            self._eps = torch.tensor(float(static_pivot),
                                     dtype=self.a_values.real.dtype, device=dev)
            self._count = torch.zeros((), dtype=torch.int32, device=dev)
        self._graph = self._capture(self.a_values, self._buf, self._count)
        self._batch = None            # the latest batch size's buffers
        self.last_n_dispatches = 0
        self.last_n_perturbed = None

    def _capture(self, a_values, vals, count):
        """The whole factorization on these buffers as one CUDA graph (on
        the card with ``jit_schedule``), else None."""
        if self.device.type != "cuda" or not self.jit_schedule:
            return None
        return CapturedSchedule(lambda: self._program(a_values, vals, count),
                                self.device, 1 + self.n_groups)

    def _schedule_key(self):
        """The cache key of the built steps, after the reference's runner
        key (``core/factorize.py:945``): plan digest, group kinds, dtype,
        value layout, the device they live on and the shard slot (None
        unsharded), so each shard owns its index tensors."""
        return ("factorize", self.plan.digest, self._kinds, str(self.dtype),
                self.layout.name, self.nnz, str(self.device), self._slot)

    def twin(self) -> "TorchFactorizer":
        """A new factorizer with this one's plan and options: it shares the
        built steps through the executable cache and owns its own buffers
        and graphs (the graph audit replays one)."""
        return TorchFactorizer(self.plan, executable_cache=self._exec_cache,
                               **self._options)

    @property
    def kinds(self) -> tuple:
        """The schedule's kinds, one per level (the dense tail once)."""
        return self._kinds

    @property
    def _groups(self):
        return self._sched.groups

    @property
    def _step(self):
        return self._sched.step

    @property
    def _a_scatter(self):
        return self._sched.a_scatter

    @property
    def _diag_idx(self):
        return self._sched.diag_idx

    def _program(self, a_values, vals, count) -> None:
        """The whole factorization on static buffers, one matrix or a
        batch: the entry scatter of ``a_values`` into ``vals``, ``tau``
        and a zeroed bump ``count`` under static pivoting (one a matrix),
        then every step.  What a CUDA graph holds."""
        vals.zero_()
        vals[..., self._a_scatter] = a_values
        if self.static_pivot is None:
            self._sched.run(vals)
            return
        tau = self._eps * vals.abs().amax(-1)
        count.zero_()
        self._sched.run(vals, tau, count)

    def load(self, a_vals) -> None:
        """Copy A values (the plan's A entry order; host or device) into
        the static input buffer."""
        with tracing.span("glu.upload", self.device, h2d_bytes=self.a_values):
            self.a_values.copy_(torch.as_tensor(a_vals, dtype=self.dtype))

    def run(self) -> torch.Tensor:
        """Factorize the loaded A values: one replay of the captured graph
        on the card, the steps one by one otherwise.  Returns the (nnz,)
        factored values, a view of the static buffer."""
        self.last_n_dispatches = self._dispatch(
            self._graph, self.a_values, self._buf, self._count)
        self.last_n_perturbed = self._count
        self.last_shard = self.last_n_perturbed_global = None
        return self._buf[: self.nnz]

    def _dispatch(self, graph, a_values, vals, count) -> int:
        if graph is not None:
            return graph()
        with tracing.span("exec.eager", self.device, eager_steps=1 + self.n_groups):
            self._program(a_values, vals, count)
        return 1 + self.n_groups

    def factorize(self, a_vals) -> torch.Tensor:
        """Scatter A values (the plan's A entry order) into the filled
        pattern and factorize: :meth:`load` then :meth:`run`."""
        self.load(a_vals)
        return self.run()

    # -- batched refactorization (one plan, many matrices) -----------------
    def _bind_batch(self, B: int) -> dict:
        """Static buffers and graph of a batch of ``B`` matrices: the
        (B, nnz_A) input, the (B, nnz + 1) filled values and (B,) bump
        counts.  A new batch size binds new ones (and captures anew on the
        card); the built steps are the single matrix's, shared."""
        st = self._batch
        if st is None or st["B"] != B:
            dev, dt = self.device, self.dtype
            st = dict(B=B,
                      a_values=torch.zeros((B, len(self.plan.a_scatter)),
                                           dtype=dt, device=dev),
                      buf=torch.zeros((B, self.nnz + 1), dtype=dt, device=dev),
                      count=(None if self.static_pivot is None else
                             torch.zeros(B, dtype=torch.int32, device=dev)))
            st["graph"] = self._capture(st["a_values"], st["buf"], st["count"])
            self._batch = st
        return st

    def _shard_executors(self) -> list:
        """One factorizer a shard, on its device with this one's options,
        its schedule cached under its own slot: built at the first sharded
        batch."""
        if self._shards is None:
            desc = self.shard.descriptor
            opts = dict(self._options, shard=None)
            self._shards = [
                TorchFactorizer(self.plan, executable_cache=self._exec_cache,
                                shard_slot=(desc, i), **dict(opts, device=d))
                for i, d in enumerate(self.shard.devices)]
        return self._shards

    def load_batched(self, a_vals_batch):
        """Copy (B, nnz_A) A values, one matrix a row (host or device),
        into the static input buffer of batch size B; returns it.  Under a
        sharding that divides B, each row block goes to its shard's buffer
        on its device, and the buffers come back as a
        :class:`~repro_torch.distributed.ShardedBatch`."""
        a = torch.as_tensor(a_vals_batch, dtype=self.dtype)
        if a.dim() != 2 or a.shape[1] != len(self.plan.a_scatter):
            raise ValueError(f"expected (B, {len(self.plan.a_scatter)}) "
                             f"values, got shape {tuple(a.shape)}")
        if self.shard is None or a.shape[0] % self.shard.n_shards:
            self._sharded_in = None
            st = self._bind_batch(a.shape[0])
            with tracing.span("glu.upload", self.device, h2d_bytes=st["a_values"]):
                st["a_values"].copy_(a)
            return st["a_values"]
        parts = [f.load_batched(block) for f, block in
                 zip(self._shard_executors(), self.shard.split(a))]
        sb = self._sharded_in
        if sb is None or any(p is not q for p, q in zip(parts, sb.parts)):
            sb = self._sharded_in = ShardedBatch(self.shard, parts)
        return sb

    def run_batched(self):
        """Factorize the loaded batch: every step once for the whole batch
        (one K1 launch per run, one batched K2/K3 launch for the dense
        tails), one graph replay on the card.  Returns the (B, nnz)
        factored values, a view of the static buffer; row b equals
        :meth:`factorize` of matrix b bit for bit.  A sharded batch runs
        one replay a shard, all launched before any host read, and comes
        back as a :class:`~repro_torch.distributed.ShardedBatch` of the
        shards' views."""
        if self._sharded_in is not None:
            return self._run_sharded()
        st = self._batch
        if st is None:
            raise RuntimeError("call load_batched() first")
        self.last_n_dispatches = self._dispatch(
            st["graph"], st["a_values"], st["buf"], st["count"])
        self.last_n_perturbed = st["count"]
        self.last_shard = self.last_n_perturbed_global = None
        return st["buf"][:, : self.nnz]

    def _run_sharded(self) -> ShardedBatch:
        subs = self._shards
        out = ShardedBatch(self.shard, [f.run_batched() for f in subs])
        self.last_n_dispatches = max(f.last_n_dispatches for f in subs)
        self.last_shard = self.shard
        if self.static_pivot is None:
            self.last_n_perturbed = self.last_n_perturbed_global = None
        else:
            counts = [f.last_n_perturbed for f in subs]
            self.last_n_perturbed = ShardedBatch(self.shard, counts)
            self.last_n_perturbed_global = psum_exact(
                [c.sum() for c in counts])
        return out

    def factorize_batched(self, a_vals_batch) -> torch.Tensor:
        """Factorize B matrices on this plan in lockstep: (B, nnz_A) values
        in the plan's A entry order, :meth:`load_batched` then
        :meth:`run_batched`."""
        self.load_batched(a_vals_batch)
        return self.run_batched()

    def factorize_filled(self, vals) -> torch.Tensor:
        """Factorize an already-filled (nnz,) value array (not modified),
        with the steps one by one, into a new tensor."""
        buf = torch.zeros(self.nnz + 1, dtype=self.dtype, device=self.device)
        buf[: self.nnz] = torch.as_tensor(vals, dtype=self.dtype,
                                          device=self.device)
        return self._run(buf)

    def _run(self, vals) -> torch.Tensor:
        """Every step, one by one, in place on a filled (nnz + 1,) value
        array; returns its first nnz values."""
        if self.static_pivot is None:
            self._sched.run(vals)
            self.last_n_perturbed = None
        else:
            count = torch.zeros((), dtype=torch.int32, device=self.device)
            self._sched.run(vals, self._eps * vals.abs().max(), count)
            self.last_n_perturbed = count
        self.last_n_dispatches = 1 + self.n_groups
        return vals[: self.nnz]

    __call__ = factorize
