"""Column dependency detection + levelization (the paper's first contribution).

Three detectors over the filled pattern ``As``, and the exact hazard set:

* ``dependencies_upattern`` — GLU1.0 rule: column k depends on i < k iff
  ``As(i,k) != 0`` and column i of L is non-empty.  Misses double-U hazards.
* ``dependencies_doubleu`` — GLU2.0's exact double-U detection (paper
  Alg. 3): the expensive triple-nested scan.  Returned edges are *only* the
  double-U edges; GLU2.0's full dependency set is upattern ∪ doubleu.
* ``dependencies_relaxed`` — GLU3.0 (paper Alg. 4): U-pattern rule plus the
  "look left" L-row rule — a sufficient superset found in two flat loops.
* ``dependencies_exact`` — the hazard set of the level-synchronous
  executor, which the plan sanitizer (``repro_torch.analysis``) checks
  levelizations against.

Each returns the JAX package's arrays, in its order.

``levelize`` turns any edge set into levels (longest-path from sources);
``levelize_relaxed`` fuses detection+levelization the way the production
code path does (no edge materialisation).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.csc import concat_ranges as _concat_ranges
from ..sparse.csc import csc_transpose_pattern
from .symbolic import FilledPattern

__all__ = [
    "Levelization",
    "dependencies_upattern",
    "dependencies_relaxed",
    "dependencies_doubleu",
    "dependencies_exact",
    "levelize",
    "levelize_relaxed",
    "level_stats",
    "longest_path_levels",
]


@dataclasses.dataclass
class Levelization:
    levels: np.ndarray        # (n,) int32 level of each column
    order: np.ndarray         # (n,) columns grouped by level
    level_ptr: np.ndarray     # (nlevels+1,) offsets into ``order``

    @property
    def num_levels(self) -> int:
        return len(self.level_ptr) - 1

    def columns_at(self, lv: int) -> np.ndarray:
        return self.order[self.level_ptr[lv] : self.level_ptr[lv + 1]]


def _l_nonempty(As: FilledPattern) -> np.ndarray:
    """Boolean per column: does column j have any L entry (row > j)?"""
    n = As.n
    last = As.indices[np.maximum(As.indptr[1:] - 1, As.indptr[:-1])]
    out = last > np.arange(n)
    # columns with zero entries (cannot happen post-fill, diag always present)
    empty = As.indptr[1:] == As.indptr[:-1]
    out[empty] = False
    return out


def dependencies_upattern(As: FilledPattern) -> tuple[np.ndarray, np.ndarray]:
    """GLU1.0 edges as (src, dst): dst depends on src."""
    n = As.n
    cols = np.repeat(np.arange(n, dtype=np.int32), np.diff(As.indptr))
    rows = As.indices
    lne = _l_nonempty(As)
    m = (rows < cols) & lne[rows]
    return rows[m].astype(np.int64), cols[m].astype(np.int64)


def dependencies_relaxed(As: FilledPattern) -> tuple[np.ndarray, np.ndarray]:
    """GLU3.0 (Alg. 4) edges as (src, dst) — vectorised two-rule scan."""
    n = As.n
    cols = np.repeat(np.arange(n, dtype=np.int32), np.diff(As.indptr))
    rows = As.indices
    lne = _l_nonempty(As)
    up = (rows < cols) & lne[rows]          # look up: U pattern
    left = rows > cols                      # look left: L row pattern
    src = np.concatenate([rows[up], cols[left]]).astype(np.int64)
    dst = np.concatenate([cols[up], rows[left]]).astype(np.int64)
    return src, dst


def dependencies_doubleu(As: FilledPattern) -> tuple[np.ndarray, np.ndarray]:
    """GLU2.0 (Alg. 3) exact double-U detection.  Deliberately faithful to the
    paper's triple-nested structure (this is the slow baseline being
    replaced); row patterns come from a CSR view, membership tests use
    sorted-array intersection."""
    n = As.n
    indptr_t, indices_t, _ = csc_transpose_pattern(n, As.indptr, As.indices)

    def row_pattern(i):
        return indices_t[indptr_t[i] : indptr_t[i + 1]]

    src, dst = [], []
    for i in range(n):
        Ii = row_pattern(i)
        s, e = int(As.indptr[i]), int(As.indptr[i + 1])
        col_i = As.indices[s:e]
        for t in col_i[col_i > i]:          # A_s(t, i) != 0, t > i
            ts, te = int(As.indptr[t]), int(As.indptr[t + 1])
            col_t = As.indices[ts:te]
            hit = False
            for j in col_t[col_t >= t]:     # A_s(j, t) != 0
                Ij = row_pattern(j)
                # exists k in Ii ∩ Ij with k > t ?
                ka = Ii[np.searchsorted(Ii, t + 1):]
                kb = Ij[np.searchsorted(Ij, t + 1):]
                if len(np.intersect1d(ka, kb, assume_unique=True)):
                    hit = True
                    break
            if hit:
                src.append(int(i))
                dst.append(int(t))
    return np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64)


def dependencies_exact(As: FilledPattern) -> tuple[np.ndarray, np.ndarray]:
    """Exact hazard set of the level-synchronous right-looking executor.

    Source column j — with L rows R(j) = {r > j : As(r,j) != 0} and U-row
    targets K(j) = {k > j : As(j,k) != 0} — writes the entries (r, k) for
    every (r, k) in R(j) x K(j).  The written entry belongs to column
    max(r, k) and is consumed at the level of column min(r, k): the
    normalisation of min(r,k) when r >= k, the update sourced at row r when
    r < k.  Deduplicating j -> min(r, k) over the cross product gives

        { j -> k : k in K(j), k <= max R(j) }  ∪
        { j -> r : r in R(j), r < max K(j) }

    — O(nnz) edges, a strict subset of the relaxed rule (which takes ALL of
    K(j) and R(j)); the j -> r edges with As(j, r) == 0 are exactly the
    double-U hazards GLU1.0 misses.  Any levelization is a valid schedule
    for the executor iff every one of these edges is strictly
    level-forward — which is what ``repro_torch.analysis.verify_plan`` checks.
    """
    n = As.n
    indptr = As.indptr.astype(np.int64)
    rows = As.indices.astype(np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    low = rows > cols                       # L entries (r, j)
    maxR = np.full(n, -1, dtype=np.int64)
    np.maximum.at(maxR, cols[low], rows[low])
    indptr_t, indices_t, _ = csc_transpose_pattern(n, As.indptr, As.indices)
    rws = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr_t))
    kcols = indices_t.astype(np.int64)
    upr = kcols > rws                       # U entries (j, k)
    maxK = np.full(n, -1, dtype=np.int64)
    np.maximum.at(maxK, rws[upr], kcols[upr])
    m1 = upr & (kcols <= maxR[rws])         # j -> k, consumed by norm of k
    m2 = low & (rows < maxK[cols])          # j -> r, consumed by source r
    src = np.concatenate([rws[m1], cols[m2]])
    dst = np.concatenate([kcols[m1], rows[m2]])
    return src, dst


def _levels_to_levelization(levels: np.ndarray) -> Levelization:
    nlev = int(levels.max()) + 1 if len(levels) else 0
    order = np.argsort(levels, kind="stable").astype(np.int32)
    counts = np.bincount(levels, minlength=nlev)
    level_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return Levelization(levels.astype(np.int32), order, level_ptr)


def longest_path_levels(n: int, src: np.ndarray, dst: np.ndarray,
                        round_cap: int = 128) -> np.ndarray:
    """Longest-path level of every node of a DAG whose edges all satisfy
    ``src < dst`` (duplicate edges allowed).

    Vectorised frontier sweep: each round finalizes every node whose
    in-edges are all resolved and pushes ``level+1`` along its out-edges, so
    each edge is touched exactly once — O(E) total plus a handful of numpy
    calls per round.  Chain-like graphs (critical path ~ n) would degenerate
    into n tiny rounds, so after ``round_cap`` rounds the unfinished
    remainder falls back to the sequential index-order sweep, which is valid
    because every source of a pending node has a smaller index.
    """
    levels = np.zeros(n, dtype=np.int64)
    if len(src) == 0 or n == 0:
        return levels
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    o = np.argsort(src, kind="stable")
    src_s, dst_s = src[o], dst[o]
    optr = np.searchsorted(src_s, np.arange(n + 1))
    pend = np.bincount(dst_s, minlength=n)   # unresolved in-edges, with multiplicity
    frontier = np.flatnonzero(pend == 0)
    rounds = 0
    while frontier.size and rounds < round_cap:
        cnt = optr[frontier + 1] - optr[frontier]
        f = frontier[cnt > 0]
        if f.size == 0:
            break
        e = _concat_ranges(optr[f], optr[f + 1])
        d = dst_s[e]
        np.maximum.at(levels, d, np.repeat(levels[f] + 1, (optr[f + 1] - optr[f])))
        np.subtract.at(pend, d, 1)
        frontier = np.unique(d[pend[d] == 0])
        rounds += 1
    remaining = np.flatnonzero(pend > 0)
    if remaining.size:
        o2 = np.argsort(dst_s, kind="stable")
        src_d, dst_d = src_s[o2], dst_s[o2]
        dptr = np.searchsorted(dst_d, np.arange(n + 1))
        for k in remaining.tolist():             # ascending: sources final first
            levels[k] = levels[src_d[dptr[k] : dptr[k + 1]]].max() + 1
    return levels


def levelize(n: int, src: np.ndarray, dst: np.ndarray) -> Levelization:
    """Longest-path levels from an explicit edge list (all edges src < dst)."""
    return _levels_to_levelization(longest_path_levels(n, src, dst))


def levelize_relaxed(As: FilledPattern) -> Levelization:
    """Fused Alg. 4 + levelization (production path)."""
    src, dst = dependencies_relaxed(As)
    return levelize(As.n, src, dst)


def level_stats(As: FilledPattern, lv: Levelization):
    """Per-level (n_columns, max_subcolumns, total_updates) — the Fig. 10 data.

    subcolumns of column j = nonzeros of row j right of the diagonal;
    updates of column j = nnz_L(j) * n_subcolumns(j).
    """
    n = As.n
    indptr_t, indices_t, _ = csc_transpose_pattern(n, As.indptr, As.indices)
    cols = np.repeat(np.arange(n, dtype=np.int32), np.diff(As.indptr))
    nnz_l = np.bincount(cols[As.indices > cols], minlength=n)
    rows_r = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr_t))
    nsub = np.bincount(rows_r[indices_t > rows_r], minlength=n)
    upd = nnz_l.astype(np.int64) * nsub.astype(np.int64)
    nlev = lv.num_levels
    out = np.zeros((nlev, 3), dtype=np.int64)
    for l in range(nlev):
        cs = lv.columns_at(l)
        out[l, 0] = len(cs)
        out[l, 1] = nsub[cs].max() if len(cs) else 0
        out[l, 2] = upd[cs].sum()
    return out
