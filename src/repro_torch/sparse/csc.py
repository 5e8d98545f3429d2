"""Compressed sparse column (CSC) containers.

The GLU pipeline works on a *static* sparsity pattern: the structure
(``indptr``/``indices``) lives on the host as numpy int32 arrays, while the
numeric values are a flat device array that gets rewritten on every
(re)factorization.  This mirrors the paper's split between CPU symbolic
analysis and GPU numeric factorization.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["CSC", "concat_ranges", "csc_from_coo", "csc_to_dense",
           "csc_transpose_pattern", "pattern_digest"]


def concat_ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Vectorised concatenation of the half-open ranges [starts[i], ends[i]).

    The workhorse of the host-side symbolic passes: gathering many CSC column
    slices in one shot without a python loop.
    """
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    nz = counts > 0
    first = offsets[nz]
    starts_nz = starts[nz].astype(np.int64)
    counts_nz = counts[nz]
    out[first] = starts_nz
    out[first[1:]] -= (starts_nz + counts_nz)[:-1] - 1
    return np.cumsum(out)


def pattern_digest(*parts) -> str:
    """Content hash of a sparsity pattern (or any tuple of arrays/strings/
    scalars): the address of a cached symbolic plan."""
    import hashlib

    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            a = np.ascontiguousarray(p)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return h.hexdigest()


@dataclasses.dataclass
class CSC:
    """Column-compressed sparse matrix with host-side structure.

    ``indptr``:  (n+1,) int32 — column start offsets.
    ``indices``: (nnz,) int32 — row indices, sorted ascending within a column.
    ``data``:    (nnz,) float or complex — numeric values (numpy array).
    """

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def col(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        """Row indices and values of column ``j``."""
        s, e = int(self.indptr[j]), int(self.indptr[j + 1])
        return self.indices[s:e], self.data[s:e]

    def value_index(self, i: int, j: int) -> int:
        """Flat index into ``data`` of element (i, j); -1 if structurally zero."""
        s, e = int(self.indptr[j]), int(self.indptr[j + 1])
        pos = np.searchsorted(self.indices[s:e], i)
        if pos < e - s and self.indices[s + pos] == i:
            return s + int(pos)
        return -1

    def diag_value_indices(self) -> np.ndarray:
        """Flat data index of each diagonal element (requires zero-free diag)."""
        out = np.empty(self.n, dtype=np.int64)
        for j in range(self.n):
            k = self.value_index(j, j)
            if k < 0:
                raise ValueError(f"structurally zero diagonal at column {j}")
            out[j] = k
        return out

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix(
            (np.asarray(self.data), self.indices, self.indptr), shape=(self.n, self.n)
        )

    def copy(self) -> "CSC":
        return CSC(self.n, self.indptr.copy(), self.indices.copy(), np.asarray(self.data).copy())

    def permute(self, row_perm: np.ndarray, col_perm: np.ndarray) -> "CSC":
        """Return P_r @ A @ P_c^T, i.e. new[row_perm[i], col_perm[j]] = old[i, j].

        ``row_perm``/``col_perm`` map old index -> new index.
        """
        coo_r, coo_c, coo_v = self.to_coo()
        return csc_from_coo(self.n, row_perm[coo_r], col_perm[coo_c], coo_v)

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cols = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))
        return self.indices.copy(), cols, np.asarray(self.data).copy()


def csc_from_coo(n: int, rows, cols, vals, sum_duplicates: bool = True) -> CSC:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    # preserve floating/complex value dtypes (AC matrices are complex128);
    # anything else (ints, python lists of floats) becomes float64
    vals = np.asarray(vals)
    if not np.issubdtype(vals.dtype, np.inexact):
        vals = vals.astype(np.float64)
    order = np.lexsort((rows, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and len(rows):
        key = cols * n + rows
        uniq, inv = np.unique(key, return_inverse=True)
        out_v = np.zeros(len(uniq), dtype=vals.dtype)
        np.add.at(out_v, inv, vals)
        rows = (uniq % n).astype(np.int32)
        cols = (uniq // n).astype(np.int32)
        vals = out_v
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(indptr, cols.astype(np.int64) + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int64).astype(np.int32)
    return CSC(n, indptr, rows.astype(np.int32), vals)


def csc_to_dense(A: CSC) -> np.ndarray:
    out = np.zeros((A.n, A.n),
                   dtype=np.result_type(np.asarray(A.data).dtype, np.float64))
    for j in range(A.n):
        idx, v = A.col(j)
        out[idx, j] = np.asarray(v)
    return out


def csc_transpose_pattern(n: int, indptr: np.ndarray, indices: np.ndarray):
    """CSR view of a CSC pattern (row-compressed): returns (indptr_t, indices_t, pos_t).

    ``pos_t[k]`` is the flat CSC data index of the k-th entry of the CSR view,
    letting row-wise scans address the same value array.
    """
    counts = np.bincount(indices, minlength=n)
    indptr_t = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    cols = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    # stable sort by row; within a row, original (column-ascending) order holds
    order = np.argsort(indices, kind="stable")
    indices_t = cols[order]
    pos_t = order.astype(np.int64)
    return indptr_t, indices_t, pos_t
