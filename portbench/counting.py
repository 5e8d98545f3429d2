"""The work a factorization and a solve need, counted from the filled
pattern alone, and the card's peaks: the yardstick of the roofline shares.

Nothing here reads how the port lays the work out (runs, levels, kernels):
a later change to the schedule or the kernels meets the same count.  The
filled pattern is the port's (its ordering decides the fill), the counting
rule is this file's.

Factorization, no pivoting, right-looking: pivot k updates every (i, j)
with L(i, k) and U(k, j) both present, one multiply-add a triple, and
divides each L entry by its pivot once.  Solve: one multiply-add a factor
entry.  Real values count 2 operations a multiply-add, complex 8; a
division counts 1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth, and the FP64
# tensor-core rate (equal to FP32 outside the tensor cores).  A share is
# stated against these, beside the card's power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
INDEX_BYTES = 4


@dataclasses.dataclass
class Work:
    ops: float
    bytes: float

    def least_s(self) -> float:
        """The least time the card needs: the larger of the two bounds."""
        return max(self.ops / PEAK_OPS_PER_S, self.bytes / PEAK_BYTES_PER_S)


def _lu_counts(n: int, indptr, indices):
    """Below-diagonal entries of each column of L, right-of-diagonal entries
    of each row of U."""
    indptr = np.asarray(indptr, dtype=np.int64)
    rows = np.asarray(indices, dtype=np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    l_col = np.bincount(cols[rows > cols], minlength=n)
    u_row = np.bincount(rows[rows < cols], minlength=n)
    return l_col, u_row


def update_triples(n: int, indptr, indices) -> int:
    """The (i, k, j) updates of an LU on the filled pattern."""
    l_col, u_row = _lu_counts(n, indptr, indices)
    return int(l_col @ u_row)


def factor_work(n: int, indptr, indices, nnz_a: int, complex_values: bool,
                batch: int = 1) -> Work:
    """A call that factors ``batch`` matrices: each filled value read and
    written once, each A value read once, one index a filled entry read
    once for the whole batch."""
    nnz = int(np.asarray(indptr)[-1])
    l_col, _ = _lu_counts(n, indptr, indices)
    mac = 8 if complex_values else 2
    ops = batch * (mac * update_triples(n, indptr, indices) + int(l_col.sum()))
    vsize = 16 if complex_values else 8
    nbytes = batch * (2 * nnz + nnz_a) * vsize + INDEX_BYTES * nnz
    return Work(float(ops), float(nbytes))


def _reach(n: int, ptr: np.ndarray, adj: np.ndarray, start) -> np.ndarray:
    """Mask of the nodes reachable from ``start`` along ``adj`` (CSR)."""
    seen = np.zeros(n, dtype=bool)
    frontier = np.unique(np.asarray(start, dtype=np.int64))
    seen[frontier] = True
    while frontier.size:
        nxt = np.concatenate([adj[ptr[j]:ptr[j + 1]] for j in frontier])
        nxt = np.unique(nxt)
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen


def _csr(n: int, cols: np.ndarray, rows: np.ndarray, keep: np.ndarray):
    """The kept entries as an adjacency from column to rows (entries are
    in column order)."""
    ptr = np.concatenate([[0], np.cumsum(np.bincount(cols[keep], minlength=n))])
    return ptr, rows[keep]


def solve_work(n: int, indptr, indices, complex_values: bool, batch: int = 1,
               support: Optional[np.ndarray] = None) -> Work:
    """A call that solves ``batch`` right-hand sides on their own factors.
    ``support``: the right-hand sides' nonzero rows in the filled
    pattern's numbering; then only the columns of L reachable from them,
    and the columns of U reachable from those, hold work.  Each factor
    value read once a system and each index once a call; each right-hand
    side and solution entry moved once."""
    indptr = np.asarray(indptr, dtype=np.int64)
    rows = np.asarray(indices, dtype=np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    lower = rows > cols
    if support is None:
        entries = len(rows)
    else:
        # L column j feeds rows i > j; U column j feeds rows i < j
        l_keep = _reach(n, *_csr(n, cols, rows, lower), support)
        u_keep = _reach(n, *_csr(n, cols, rows, rows < cols),
                        np.flatnonzero(l_keep))
        entries = int((lower & l_keep[cols]).sum() + (~lower & u_keep[cols]).sum())
    mac = 8 if complex_values else 2
    vsize = 16 if complex_values else 8
    ops = batch * mac * entries
    nbytes = batch * (entries * vsize + 2 * n * vsize) + INDEX_BYTES * entries
    return Work(float(ops), float(nbytes))
