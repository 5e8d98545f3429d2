"""Preprocessing: MC64 matching/scaling and fill-reducing ordering
(minimum-degree / RCM).

The GLU flow (paper Fig. 5) runs MC64 + AMD before symbolic analysis.  Here:

* ``zero_free_diagonal`` — maximum-cardinality bipartite matching (the
  structural half of MC64 only).
* ``max_product_matching`` — the full Duff-Koster MC64 (job 5): a row
  permutation maximising the product of diagonal magnitudes, plus the dual
  row/column scalings ``Dr``/``Dc`` that make every scaled entry <= 1 in
  magnitude with exact 1s on the matched (diagonal) positions.  This is the
  numerical half that pivoting-free LU relies on.
* ``minimum_degree`` — classic minimum-degree on the symmetrised pattern
  (pure python; fine to ~20k columns on this host).
* ``rcm`` — reverse Cuthill-McKee via scipy (fast C path for large n).
* ``fill_reducing_ordering`` — dispatcher used by the GLU facade.

All orderings return ``perm`` with the convention new = perm[old]
(i.e. ``A.permute(perm, perm)`` applies it).
"""
from __future__ import annotations

import heapq

import numpy as np

from ..sparse.csc import CSC

__all__ = [
    "zero_free_diagonal",
    "max_product_matching",
    "minimum_degree",
    "rcm",
    "fill_reducing_ordering",
    "resolve_ordering_method",
]


def zero_free_diagonal(A: CSC) -> np.ndarray:
    """Row permutation (old row -> new row) giving a structurally zero-free diagonal.

    Uses scipy's Hopcroft-Karp maximum bipartite matching on the pattern.
    Raises if the matrix is structurally singular.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_bipartite_matching

    S = sp.csc_matrix(
        (np.ones(A.nnz, dtype=np.int8), A.indices, A.indptr), shape=(A.n, A.n)
    )
    # match[col] = row assigned to column col
    match = maximum_bipartite_matching(S.tocsr(), perm_type="row")
    if (match < 0).any():
        raise ValueError("matrix is structurally singular (no perfect matching)")
    # we need row old->new such that new_row(match[j]) == j
    perm = np.empty(A.n, dtype=np.int64)
    perm[match] = np.arange(A.n)
    return perm


def max_product_matching(A: CSC):
    """Duff-Koster MC64 max-product matching with dual scalings.

    Finds the row permutation maximising ``prod_j |A[match(j), j]|`` by
    solving the equivalent linear assignment problem with costs
    ``c[i,j] = log(colmax_j) - log|a[i,j]|`` (sparse successive shortest
    augmenting paths with dual potentials ``u`` on rows, ``v`` on columns).

    Returns ``(row_perm, Dr, Dc)`` where ``row_perm`` is old row -> new row
    (matched entries land on the diagonal) and the scalings satisfy
    ``|Dr[i] * A[i, j] * Dc[j]| <= 1`` for every stored entry, with equality
    on the matched ones.  Raises on structurally or numerically singular
    input (a perfect matching over the nonzero values must exist).

    Cost: the cheap pass (a column's max entry has zero cost) matches every
    column of a diagonally dominant matrix in O(nnz); only columns it
    leaves unmatched pay the pure-python Dijkstra, O(nnz log n) each, so
    badly-matched large instances can be slow — ``GLU(mc64="structural")``
    keeps the scipy C matching for those.
    """
    n = A.n
    indptr, indices = A.indptr, A.indices
    # Duff-Koster is defined on entry magnitudes: take |a_ij| BEFORE any
    # dtype cast, so complex matrices (AC analysis) match on |G + jwC|
    absval = np.abs(np.asarray(A.data)).astype(np.float64)
    colmax = np.zeros(n)
    np.maximum.at(colmax, np.repeat(np.arange(n), np.diff(indptr)), absval)
    if (colmax == 0).any():
        raise ValueError("numerically singular: column of exact zeros")
    cols_of = np.repeat(np.arange(n), np.diff(indptr))
    with np.errstate(divide="ignore"):
        cost = np.log(colmax[cols_of]) - np.log(absval)  # inf on zero entries

    u = np.zeros(n)                      # row duals
    v = np.zeros(n)                      # column duals
    row_to_col = np.full(n, -1, dtype=np.int64)
    col_to_row = np.full(n, -1, dtype=np.int64)

    # cheap pass: a column's max entry has cost 0, so matching it keeps the
    # zero duals feasible and tight
    for j in range(n):
        s, e = int(indptr[j]), int(indptr[j + 1])
        for p in range(s, e):
            if cost[p] == 0.0 and row_to_col[indices[p]] == -1:
                row_to_col[indices[p]] = j
                col_to_row[j] = int(indices[p])
                break

    inf = np.inf
    for j0 in np.flatnonzero(col_to_row == -1):
        # Dijkstra over rows with reduced costs c[i,j] - u[i] - v[j] >= 0
        dist = np.full(n, inf)
        prev_col = np.full(n, -1, dtype=np.int64)
        done = np.zeros(n, dtype=bool)
        heap: list = []
        j = int(j0)
        base = 0.0                       # distance to the current column
        sink = -1
        while True:
            s, e = int(indptr[j]), int(indptr[j + 1])
            for p in range(s, e):
                i = int(indices[p])
                if done[i] or cost[p] == inf:
                    continue
                nd = base + cost[p] - u[i] - v[j]
                if nd < dist[i]:
                    dist[i] = nd
                    prev_col[i] = j
                    heapq.heappush(heap, (nd, i))
            while heap:
                d_i, i = heapq.heappop(heap)
                if not done[i]:
                    break
            else:
                raise ValueError(
                    "no perfect matching over nonzero values "
                    "(matrix is structurally or numerically singular)")
            done[i] = True
            base = d_i
            if row_to_col[i] == -1:
                sink = i
                break
            j = int(row_to_col[i])
        delta = base
        # dual update keeps feasibility and makes the augmenting path tight
        fin = np.flatnonzero(done)
        u[fin] += dist[fin] - delta
        matched = fin[row_to_col[fin] >= 0]
        v[row_to_col[matched]] += delta - dist[matched]
        v[j0] += delta
        # augment along the stored predecessor columns
        i = sink
        while i != -1:
            j = int(prev_col[i])
            nxt = int(col_to_row[j])
            row_to_col[i] = j
            col_to_row[j] = i
            i = nxt

    # matched entries: u[i] + v[j] = log(colmax_j) - log|a_ij|
    #   => exp(u[i]) * |a_ij| * exp(v[j]) / colmax_j = 1
    Dr = np.exp(u)
    Dc = np.exp(v) / colmax
    row_perm = row_to_col.copy()
    return row_perm, Dr, Dc


def _sym_adjacency(A: CSC):
    """Symmetrised adjacency lists (no self loops) as a list of sets."""
    adj = [set() for _ in range(A.n)]
    cols = np.repeat(np.arange(A.n), np.diff(A.indptr))
    for r, c in zip(A.indices, cols):
        if r != c:
            adj[r].add(int(c))
            adj[c].add(int(r))
    return adj


def minimum_degree(A: CSC) -> np.ndarray:
    """Minimum-degree ordering on the symmetrised pattern (old -> new)."""
    n = A.n
    adj = _sym_adjacency(A)
    heap = [(len(adj[v]), v) for v in range(n)]
    heapq.heapify(heap)
    eliminated = np.zeros(n, dtype=bool)
    order = []
    stamp = np.full(n, -1, dtype=np.int64)
    while heap:
        d, v = heapq.heappop(heap)
        if eliminated[v] or d != len(adj[v]):
            continue  # stale entry
        eliminated[v] = True
        order.append(v)
        nbrs = [u for u in adj[v] if not eliminated[u]]
        # clique the neighbourhood (elimination graph update)
        for u in nbrs:
            adj[u].discard(v)
        for i, u in enumerate(nbrs):
            au = adj[u]
            for w in nbrs[i + 1 :]:
                if w not in au:
                    au.add(w)
                    adj[w].add(u)
        for u in nbrs:
            if stamp[u] != len(adj[u]):
                stamp[u] = len(adj[u])
                heapq.heappush(heap, (len(adj[u]), u))
        adj[v] = set()
    perm = np.empty(n, dtype=np.int64)
    perm[np.array(order)] = np.arange(n)
    return perm


def rcm(A: CSC) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrised pattern (old -> new)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = sp.csc_matrix(
        (np.ones(A.nnz, dtype=np.int8), A.indices, A.indptr), shape=(A.n, A.n)
    )
    S = (S + S.T).tocsr()
    order = reverse_cuthill_mckee(S, symmetric_mode=True)
    perm = np.empty(A.n, dtype=np.int64)
    perm[order] = np.arange(A.n)
    return perm


def resolve_ordering_method(n: int, method: str = "auto") -> str:
    """Resolve ``"auto"`` to the concrete ordering used for an n-column matrix
    (part of the plan-cache key contract: keys are stored under resolved
    method names so ``"auto"`` and its resolution share one plan)."""
    if method == "auto":
        return "mindeg" if n <= 6000 else "rcm"
    if method in ("none", "mindeg", "rcm"):
        return method
    raise ValueError(f"unknown ordering method {method!r}")


def fill_reducing_ordering(A: CSC, method: str = "auto") -> np.ndarray:
    method = resolve_ordering_method(A.n, method)
    if method == "none":
        return np.arange(A.n, dtype=np.int64)
    if method == "mindeg":
        return minimum_degree(A)
    return rcm(A)
