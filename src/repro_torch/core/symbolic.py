"""Symbolic fill-in analysis.

Three engines:

* ``symbolic_fillin_gp`` — exact Gilbert-Peierls reach-based fill (the
  paper's symbolic routine, inherited from the left-looking method).  Per
  column j it DFS-reaches the already-factorized L columns; everything
  reached is in the filled pattern.  Cost O(flops); pure host python.

* ``symbolic_fillin_vectorized`` — the same exact fill, computed by
  frontier-batched numpy reach passes instead of a per-column python DFS.
  Columns are batched by their height in the elimination tree of the
  symmetrised pattern: Liu's structure-containment theorem (L(i,j) != 0
  implies i is an ancestor of j) plus the superset relation between exact
  LU fill and the symmetrised Cholesky fill guarantee that equal-height
  columns never reach through each other, so each batch's reaches expand
  together in bulk array passes.

* ``symbolic_fillin_etree`` — elimination-tree symbolic factorization of the
  *symmetrised* pattern.  Produces a superset of the true LU fill (any
  superset is numerically exact for no-pivot LU: entries outside the true
  pattern simply factor to values that would have been computed anyway).
  Near O(nnz(L)) host cost; the default for large matrices.

All return the filled pattern ``As`` as (indptr, indices) with rows sorted
ascending per column, plus a scatter map from the original ``A`` entries into
the filled value array.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.csc import CSC, concat_ranges

__all__ = [
    "FilledPattern",
    "resolve_symbolic_method",
    "symbolic_fillin",
    "symbolic_fillin_gp",
    "symbolic_fillin_etree",
    "symbolic_fillin_vectorized",
]


@dataclasses.dataclass
class FilledPattern:
    n: int
    indptr: np.ndarray      # (n+1,) int32 filled CSC structure
    indices: np.ndarray     # (nnz,) int32
    a_scatter: np.ndarray   # (nnz_A,) int64: filled-value index of each A entry
    method: str

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def filled_csc(self, A: CSC) -> CSC:
        """Scatter A's values into the filled pattern (zeros elsewhere),
        preserving the (promoted) value dtype — complex stays complex."""
        data = np.asarray(A.data)
        vals = np.zeros(self.nnz, dtype=np.result_type(data.dtype, np.float64))
        vals[self.a_scatter] = data
        return CSC(self.n, self.indptr, self.indices, vals)


def _scatter_map(A: CSC, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """For each entry of A, its flat index in the filled pattern.

    Column-major (col, row) keys of a CSC pattern with per-column sorted rows
    are globally sorted, so one flat ``searchsorted`` over all columns
    replaces the per-column loop.
    """
    n = A.n
    fkeys = (np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr)) * n
             + indices.astype(np.int64))
    akeys = (np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr)) * n
             + A.indices.astype(np.int64))
    pos = np.searchsorted(fkeys, akeys)
    ok = pos < len(fkeys)
    ok[ok] = fkeys[pos[ok]] == akeys[ok]
    if not ok.all():
        raise AssertionError("filled pattern does not contain A pattern")
    return pos.astype(np.int64)


def symbolic_fillin_gp(A: CSC) -> FilledPattern:
    """Exact reach-based fill-in (Gilbert-Peierls symbolic step)."""
    n = A.n
    # adjacency of already-built L columns: Lrows[j] = rows > j in column j
    Lrows: list[np.ndarray] = [None] * n  # type: ignore[assignment]
    col_patterns: list[np.ndarray] = []
    visited = np.zeros(n, dtype=bool)
    indptr = np.zeros(n + 1, dtype=np.int64)
    for j in range(n):
        s, e = int(A.indptr[j]), int(A.indptr[j + 1])
        seeds = A.indices[s:e]
        touched = []
        stack = list(seeds)
        while stack:
            k = stack.pop()
            if visited[k]:
                continue
            visited[k] = True
            touched.append(k)
            if k < j:
                # expand through column k of L
                for i in Lrows[k]:
                    if not visited[i]:
                        stack.append(i)
        pattern = np.array(sorted(touched), dtype=np.int32)
        visited[touched] = False
        # diagonal must be present (zero-free diagonal assumed post-MC64)
        if pattern.searchsorted(j) >= len(pattern) or pattern[pattern.searchsorted(j)] != j:
            pattern = np.insert(pattern, pattern.searchsorted(j), j)
        col_patterns.append(pattern)
        Lrows[j] = pattern[pattern > j]
        indptr[j + 1] = indptr[j] + len(pattern)
    indices = np.concatenate(col_patterns).astype(np.int32)
    indptr = indptr.astype(np.int32)
    return FilledPattern(n, indptr, indices, _scatter_map(A, indptr, indices), "gp")


def _etree_row_structures(n: int, upper_rows: list[np.ndarray]):
    """Rows of L of the symmetrised pattern via the Liu elimination-tree scan.

    ``upper_rows[i]`` = sorted {j < i : S(i,j) != 0} of the symmetrised
    pattern.  Returns per-row L structures (lists of k < i with L(i,k) != 0).
    """
    parent = np.full(n, -1, dtype=np.int64)
    mark = np.full(n, -1, dtype=np.int64)
    rows: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        mark[i] = i
        for j in upper_rows[i]:
            k = int(j)
            while mark[k] != i:
                if parent[k] == -1:
                    parent[k] = i
                mark[k] = i
                rows[i].append(k)
                k = int(parent[k])
    return rows


def symbolic_fillin_etree(A: CSC) -> FilledPattern:
    """Symmetrised elimination-tree fill (superset of exact LU fill)."""
    n = A.n
    # build symmetrised strictly-upper row structures
    r, c, _ = A.to_coo()
    lo = np.minimum(r, c)
    hi = np.maximum(r, c)
    off = lo != hi
    lo, hi = lo[off], hi[off]
    key = hi.astype(np.int64) * n + lo.astype(np.int64)
    key = np.unique(key)
    hi_u = (key // n).astype(np.int64)
    lo_u = (key % n).astype(np.int64)
    upper_rows: list[np.ndarray] = []
    starts = np.searchsorted(hi_u, np.arange(n + 1))
    for i in range(n):
        upper_rows.append(lo_u[starts[i] : starts[i + 1]])
    rows = _etree_row_structures(n, upper_rows)
    # L row structures -> symmetric filled pattern: (i,k) and (k,i) for k in rows[i]
    total = sum(len(x) for x in rows)
    li = np.empty(total, dtype=np.int64)
    lk = np.empty(total, dtype=np.int64)
    p = 0
    for i, lst in enumerate(rows):
        m = len(lst)
        li[p : p + m] = i
        lk[p : p + m] = lst
        p += m
    rr = np.concatenate([li, lk, np.arange(n)])
    cc = np.concatenate([lk, li, np.arange(n)])
    order = np.lexsort((rr, cc))
    rr, cc = rr[order], cc[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, cc + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = rr.astype(np.int32)
    return FilledPattern(n, indptr, indices, _scatter_map(A, indptr, indices), "etree")


def _etree_symmetrized(n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Elimination tree of the symmetrised pattern (Liu's algorithm with
    path compression).  ``parent[j] > j`` for every non-root."""
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    rows = indices.astype(np.int64)
    lo = np.minimum(rows, cols)
    hi = np.maximum(rows, cols)
    off = lo != hi
    key = np.unique(hi[off] * n + lo[off])  # sorted => grouped by hi ascending
    hi_u = key // n
    lo_u = key % n
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for i, k in zip(hi_u.tolist(), lo_u.tolist()):
        r = k
        while True:
            a = ancestor[r]
            if a == i:
                break
            ancestor[r] = i
            if a == -1:
                parent[r] = i
                break
            r = a
    return parent


def _etree_heights(parent: np.ndarray) -> np.ndarray:
    """Height of each node (longest path to a leaf below it).  ``parent[j] > j``
    lets one ascending pass finalize every node before it propagates."""
    n = len(parent)
    height = np.zeros(n, dtype=np.int64)
    par = parent.tolist()
    hts = height.tolist()
    for j in range(n):
        p = par[j]
        if p >= 0 and hts[j] + 1 > hts[p]:
            hts[p] = hts[j] + 1
    return np.asarray(hts, dtype=np.int64)


def symbolic_fillin_vectorized(A: CSC) -> FilledPattern:
    """Exact Gilbert-Peierls fill via frontier-batched, etree-pruned numpy
    reach passes.

    Identical output to :func:`symbolic_fillin_gp` (same pattern, same
    per-column sorted rows, same scatter map, modulo ``method``): the reach
    closure is computed breadth-first in bulk instead of depth-first per
    column.  Batching is exact — a column's reach only ever expands through
    columns of strictly smaller etree height, so every column of one height
    batch resolves in the same group of passes.
    """
    n = A.n
    if n == 0:
        return FilledPattern(0, np.zeros(1, np.int32), np.empty(0, np.int32),
                             np.empty(0, np.int64), "vectorized")
    indptr = np.asarray(A.indptr, dtype=np.int64)
    indices = np.asarray(A.indices, dtype=np.int64)
    parent = _etree_symmetrized(n, indptr, A.indices)
    height = _etree_heights(parent)
    horder = np.argsort(height, kind="stable").astype(np.int64)
    hsorted = height[horder]
    nbatch = int(hsorted[-1]) + 1
    bptr = np.searchsorted(hsorted, np.arange(nbatch + 1))

    # growing store of completed filled-L column structures (rows > j)
    l_start = np.zeros(n, dtype=np.int64)
    l_end = np.zeros(n, dtype=np.int64)
    lbuf = np.empty(max(A.nnz, 16), dtype=np.int64)
    lused = 0
    out_rows_parts = []
    out_cols_parts = []

    # membership bitmap, one row per in-flight column; big batches are chunked
    # so the bitmap stays bounded, and it is reset via the touched indices so
    # each batch pays O(reach), not O(rows * n)
    chunk_cap = max(1, 32_000_000 // max(n, 1))
    max_rows = 0
    for b in range(nbatch):
        max_rows = max(max_rows, min(int(bptr[b + 1] - bptr[b]), chunk_cap))
    visited = np.zeros((max_rows, n), dtype=bool)
    slot = np.empty(n, dtype=np.int64)

    for b in range(nbatch):
        batch = np.sort(horder[bptr[b] : bptr[b + 1]])
        for c0 in range(0, batch.size, chunk_cap):
            bcols = batch[c0 : c0 + chunk_cap]
            nb = bcols.size
            slot[bcols] = np.arange(nb)
            seeds = indices[concat_ranges(indptr[bcols], indptr[bcols + 1])]
            seed_cols = np.repeat(bcols, (indptr[bcols + 1] - indptr[bcols]))
            visited[slot[seed_cols], seeds] = True
            visited[np.arange(nb), bcols] = True     # forced diagonal
            keep = seeds < seed_cols
            f_col, f_node = seed_cols[keep], seeds[keep]
            while f_node.size:
                cnt = l_end[f_node] - l_start[f_node]
                nz = cnt > 0
                f_node, f_col, cnt = f_node[nz], f_col[nz], cnt[nz]
                if f_node.size == 0:
                    break
                flat = concat_ranges(l_start[f_node], l_end[f_node])
                crow = lbuf[flat]
                ccol = np.repeat(f_col, cnt)
                isnew = ~visited[slot[ccol], crow]
                if not isnew.any():
                    break
                ncol, nrow = ccol[isnew], crow[isnew]
                visited[slot[ncol], nrow] = True
                f_col, f_node = np.divmod(np.unique(ncol * n + nrow), n)
                keep = f_node < f_col
                f_col, f_node = f_col[keep], f_node[keep]
            sl, rows_b = np.nonzero(visited[:nb])
            cols_b = bcols[sl]                       # column-major order
            visited[sl, rows_b] = False              # cheap reset for reuse
            out_rows_parts.append(rows_b.astype(np.int64))
            out_cols_parts.append(cols_b)
            # publish this chunk's L structures for later expansions
            lm = rows_b > cols_b
            lrows, lcols = rows_b[lm], cols_b[lm]
            need = lused + lrows.size
            if need > lbuf.size:
                lbuf = np.concatenate(
                    [lbuf, np.empty(max(lbuf.size, need - lbuf.size), np.int64)])
            lbuf[lused:need] = lrows
            l_start[bcols] = lused + np.searchsorted(lcols, bcols)
            l_end[bcols] = lused + np.searchsorted(lcols, bcols, side="right")
            lused = need

    all_cols = np.concatenate(out_cols_parts)
    all_rows = np.concatenate(out_rows_parts)
    order = np.argsort(all_cols * n + all_rows, kind="stable")
    out_indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(all_cols, minlength=n))]
    ).astype(np.int32)
    out_indices = all_rows[order].astype(np.int32)
    return FilledPattern(n, out_indptr, out_indices,
                         _scatter_map(A, out_indptr, out_indices), "vectorized")


def resolve_symbolic_method(n: int, method: str = "auto") -> str:
    """Resolve ``"auto"`` to the concrete engine used for an n-column matrix
    (part of the plan-cache key contract: keys are stored under resolved
    engine names so ``"auto"`` and its resolution share one plan)."""
    if method == "auto":
        return "gp" if n <= 3000 else "etree"
    if method in ("gp", "etree", "vectorized"):
        return method
    raise ValueError(f"unknown symbolic method {method!r}")


def symbolic_fillin(A: CSC, method: str = "auto") -> FilledPattern:
    method = resolve_symbolic_method(A.n, method)
    if method == "gp":
        return symbolic_fillin_gp(A)
    if method == "etree":
        return symbolic_fillin_etree(A)
    return symbolic_fillin_vectorized(A)
