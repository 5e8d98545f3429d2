"""Column dependency detection + levelization (the paper's first contribution).

``dependencies_relaxed`` is GLU3.0's detector (paper Alg. 4): the U-pattern
rule plus the "look left" L-row rule, a sufficient superset of the true
dependencies found in two flat loops.  (The GLU1.0/2.0 detectors and the
exact hazard set of the JAX package are not ported: the planner does not
use them.)

``levelize`` turns any edge set into levels (longest-path from sources);
``levelize_relaxed`` fuses detection+levelization the way the production
code path does (no edge materialisation).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.csc import concat_ranges as _concat_ranges
from .symbolic import FilledPattern

__all__ = [
    "Levelization",
    "dependencies_relaxed",
    "levelize",
    "levelize_relaxed",
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


