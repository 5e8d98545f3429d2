"""FactorizePlan: host-side compilation of the symbolic analysis into flat
per-level index arrays the numeric executors consume.

The plan is built once per sparsity pattern and reused across
refactorizations (the SPICE/Newton-Raphson use case the paper targets).

Per level ℓ the numeric step is:

  1. normalisation   vals[norm_idx] /= vals[norm_diag]        (L of level cols)
  2. submatrix update vals[didx]   -= vals[lidx] * vals[uidx] (all updates whose
                                                               *source* column
                                                               is in level ℓ)

Update triples are stored sorted by (level, destination column) so that the
segmented level-update kernel can process contiguous per-destination runs,
and the flat executor can slice a level in O(1).

Padding convention: all padded index slots hold ``nnz`` (one past the value
array).  The PyTorch executor keeps a trash slot at ``vals[nnz]`` for the
padded K1 layout; its flat and trisolve levels keep only real entries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..sparse.csc import concat_ranges as _concat_ranges
from ..sparse.csc import csc_transpose_pattern, pattern_digest
from .dependency import Levelization, levelize_relaxed, longest_path_levels
from .symbolic import FilledPattern

__all__ = ["FactorizePlan", "LevelSegment", "build_plan",
           "MODE_FLAT", "MODE_SEGMENTED", "MODE_PANEL"]

MODE_FLAT = "flat"            # one fused scatter-add (type A levels)
MODE_SEGMENTED = "segmented"  # per-destination-column kernel (type B)
MODE_PANEL = "panel"          # few long columns: per-column dense panel (type C)


@dataclasses.dataclass
class LevelSegment:
    """One level's numeric work (unpadded views into the plan arrays)."""

    level: int
    cols: np.ndarray        # columns factorised at this level
    norm_slice: slice       # into norm_idx / norm_diag
    upd_slice: slice        # into lidx / uidx / didx (and dst_col)
    mode: str

    @property
    def n_norm(self) -> int:
        return self.norm_slice.stop - self.norm_slice.start

    @property
    def n_upd(self) -> int:
        return self.upd_slice.stop - self.upd_slice.start


@dataclasses.dataclass
class FactorizePlan:
    n: int
    nnz: int
    indptr: np.ndarray
    indices: np.ndarray
    diag_idx: np.ndarray          # (n,) flat value index of each diagonal
    levels: Levelization
    # normalisation arrays, concatenated in level order
    norm_idx: np.ndarray
    norm_diag: np.ndarray
    # update triples, sorted by (level, destination column)
    lidx: np.ndarray
    uidx: np.ndarray
    didx: np.ndarray
    dst_col: np.ndarray
    segments: list[LevelSegment]
    a_scatter: np.ndarray         # original A entry -> filled value index
    # trisolve plans
    fwd_rows: np.ndarray          # L entry row i
    fwd_cols: np.ndarray          # L entry col j
    fwd_vidx: np.ndarray          # L entry value index
    fwd_ptr: np.ndarray           # per-L-level offsets into fwd_* (by level of j)
    bwd_rows: np.ndarray
    bwd_cols: np.ndarray
    bwd_vidx: np.ndarray
    bwd_ptr: np.ndarray
    bwd_level_cols: np.ndarray    # columns ordered by U-level
    bwd_col_ptr: np.ndarray
    # CSR-ish DAG adjacency of L (below-diagonal rows per column) and U
    # (above-diagonal rows per column), the JAX package's sparse-RHS reach
    # machinery; kept so the plan arrays stay those of the reference
    l_adj_ptr: np.ndarray
    l_adj_rows: np.ndarray
    u_adj_ptr: np.ndarray
    u_adj_rows: np.ndarray
    # content address of this plan (pattern + levelization): the key under
    # which whole-schedule executables are cached process-wide, so two
    # executors built on equal plans share one compiled program
    digest: str = ""

    @property
    def num_levels(self) -> int:
        return self.levels.num_levels

    @property
    def total_updates(self) -> int:
        return len(self.lidx)

    def flops(self) -> int:
        """2 flops per MAC update + 1 per normalisation division."""
        return 2 * len(self.lidx) + len(self.norm_idx)


def _mode_for_level(n_cols: int, n_upd: int, panel_threshold: int) -> str:
    """Paper Fig. 10 mode criteria: wide levels are type A (flat
    scatter-add), and the narrow ones split on *update volume*, not column
    count alone — a narrow level whose few columns carry a huge update load
    (long fill-heavy columns near the root of the etree) is type B
    (segmented per-destination accumulation), while a narrow level with
    genuinely small per-column work is type C (dense panel)."""
    if n_cols > 4 * panel_threshold:
        return MODE_FLAT
    if n_cols <= panel_threshold and n_upd <= 32 * panel_threshold * n_cols:
        return MODE_PANEL
    return MODE_SEGMENTED


def build_plan(
    As: FilledPattern,
    lv: Optional[Levelization] = None,
    panel_threshold: int = 16,
) -> FactorizePlan:
    n, indptr, indices = As.n, As.indptr.astype(np.int64), As.indices
    if lv is None:
        lv = levelize_relaxed(As)
    levels = lv.levels.astype(np.int64)

    # diagonal positions: one flat searchsorted over column-major (col, row)
    # keys, which are globally sorted for a CSC pattern
    cols_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    fkeys = cols_of * n + indices.astype(np.int64)
    diag_pos = np.searchsorted(fkeys, np.arange(n, dtype=np.int64) * (n + 1))
    bad = diag_pos >= len(fkeys)
    bad[~bad] = fkeys[diag_pos[~bad]] != np.arange(n, dtype=np.int64)[~bad] * (n + 1)
    if bad.any():
        j = int(np.flatnonzero(bad)[0])
        raise ValueError(f"zero diagonal at column {j} (run MC64 first)")
    l_start = diag_pos + 1
    l_end = indptr[1:]
    nnz_l = (l_end - l_start).astype(np.int64)

    # --- normalisation arrays grouped by level -----------------------------
    order = lv.order.astype(np.int64)
    norm_idx = _concat_ranges(l_start[order], l_end[order])
    norm_diag = np.repeat(diag_pos[order], nnz_l[order])
    norm_counts = np.zeros(lv.num_levels, dtype=np.int64)
    np.add.at(norm_counts, levels[order.astype(np.int64)], nnz_l[order])
    norm_ptr = np.concatenate([[0], np.cumsum(norm_counts)])

    # --- update triples, destination-column major --------------------------
    # one bulk pass over all U entries: the per-destination-column loop is a
    # gather (U entry -> source column) + ranged concat (source L rows) +
    # one flat searchsorted into the global (col, row) key array
    u_flat = _concat_ranges(indptr[:-1], diag_pos)   # U entries, col-major
    jj = indices[u_flat].astype(np.int64)            # source column per U entry
    cnt = nnz_l[jj]
    lidx = _concat_ranges(l_start[jj], l_end[jj])
    uidx = np.repeat(u_flat, cnt)
    dst = np.repeat(cols_of[u_flat], cnt)
    didx = np.searchsorted(fkeys, dst * n + indices[lidx].astype(np.int64))
    lev = np.repeat(levels[jj], cnt)
    srt = np.argsort(lev, kind="stable")  # within level: dst ascending
    lidx, uidx, didx, lev, dst = lidx[srt], uidx[srt], didx[srt], lev[srt], dst[srt]
    upd_ptr = np.searchsorted(lev, np.arange(lv.num_levels + 1))

    segments = []
    for l in range(lv.num_levels):
        cols = lv.columns_at(l)
        nu = int(upd_ptr[l + 1] - upd_ptr[l])
        segments.append(
            LevelSegment(
                level=l,
                cols=cols,
                norm_slice=slice(int(norm_ptr[l]), int(norm_ptr[l + 1])),
                upd_slice=slice(int(upd_ptr[l]), int(upd_ptr[l + 1])),
                mode=_mode_for_level(len(cols), nu, panel_threshold),
            )
        )

    # --- forward trisolve plan (L levels == factorisation levels) ----------
    all_cols_l = np.repeat(np.arange(n, dtype=np.int64), nnz_l)
    fwd_vidx = _concat_ranges(l_start, l_end)
    fwd_rows = indices[fwd_vidx].astype(np.int64)
    fwd_cols = all_cols_l
    # reach adjacency of the L DAG: captured column-major, before level sort
    l_adj_ptr = np.concatenate([[0], np.cumsum(nnz_l)]).astype(np.int64)
    l_adj_rows = fwd_rows.copy()
    fwd_lev = levels[fwd_cols]
    srt = np.argsort(fwd_lev, kind="stable")
    fwd_rows, fwd_cols, fwd_vidx, fwd_lev = (
        fwd_rows[srt], fwd_cols[srt], fwd_vidx[srt], fwd_lev[srt])
    fwd_ptr = np.searchsorted(fwd_lev, np.arange(lv.num_levels + 1))

    # --- backward trisolve plan (U levels, computed descending) ------------
    # ulev[j] = longest chain through row entries k > j; mirroring indices
    # (j -> n-1-j) turns it into the standard src < dst longest-path problem
    indptr_t, indices_t, pos_t = csc_transpose_pattern(n, As.indptr, As.indices)
    rows_t = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr_t))
    um = indices_t > rows_t
    ulev = longest_path_levels(
        n, n - 1 - indices_t[um].astype(np.int64), n - 1 - rows_t[um])[::-1].copy()
    nulev = int(ulev.max()) + 1 if n else 0
    u_start = indptr[:-1]
    u_end = diag_pos  # strictly-above-diagonal entries
    nnz_u = (u_end - u_start).astype(np.int64)
    bwd_vidx = _concat_ranges(u_start, u_end)
    bwd_rows = indices[bwd_vidx].astype(np.int64)
    bwd_cols = np.repeat(np.arange(n, dtype=np.int64), nnz_u)
    # reach adjacency of the U DAG, same column-major capture
    u_adj_ptr = np.concatenate([[0], np.cumsum(nnz_u)]).astype(np.int64)
    u_adj_rows = bwd_rows.copy()
    bwd_lev = ulev[bwd_cols]
    srt = np.argsort(bwd_lev, kind="stable")
    bwd_rows, bwd_cols, bwd_vidx, bwd_lev = (
        bwd_rows[srt], bwd_cols[srt], bwd_vidx[srt], bwd_lev[srt])
    bwd_ptr = np.searchsorted(bwd_lev, np.arange(nulev + 1))
    col_order = np.argsort(ulev, kind="stable").astype(np.int64)
    bwd_col_ptr = np.searchsorted(ulev[col_order], np.arange(nulev + 1))

    return FactorizePlan(
        n=n,
        nnz=As.nnz,
        indptr=As.indptr,
        indices=indices,
        diag_idx=diag_pos,
        levels=lv,
        norm_idx=norm_idx,
        norm_diag=norm_diag,
        lidx=lidx,
        uidx=uidx,
        didx=didx,
        dst_col=dst,
        segments=segments,
        a_scatter=As.a_scatter,
        fwd_rows=fwd_rows,
        fwd_cols=fwd_cols,
        fwd_vidx=fwd_vidx,
        fwd_ptr=fwd_ptr,
        bwd_rows=bwd_rows,
        bwd_cols=bwd_cols,
        bwd_vidx=bwd_vidx,
        bwd_ptr=bwd_ptr,
        bwd_level_cols=col_order,
        bwd_col_ptr=bwd_col_ptr,
        l_adj_ptr=l_adj_ptr,
        l_adj_rows=l_adj_rows,
        u_adj_ptr=u_adj_ptr,
        u_adj_rows=u_adj_rows,
        digest=pattern_digest(As.indptr, indices, levels, order,
                              int(panel_threshold)),
    )
