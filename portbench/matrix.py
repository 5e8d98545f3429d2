"""The benchmark's own sparse matrix: a CSC pattern with values, built by
the rules under ``rules/`` and handed to the port and to the reference
alike.  ``csc_from_coo`` is a frozen copy of ``repro_torch.sparse.csc``'s,
so the stand-in matrices keep their bytes whatever the port does later."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Matrix:
    """``indptr`` (n + 1,) and ``indices`` (nnz,) int32, rows sorted within
    each column; ``data`` (nnz,) float64 or complex128."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def cols(self) -> np.ndarray:
        """The column of each entry."""
        return np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))

    def diag_mask(self) -> np.ndarray:
        return self.indices == self.cols()


def csc_from_coo(n: int, rows, cols, vals) -> Matrix:
    """COO triplets to CSC, duplicates summed (frozen copy)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if not np.issubdtype(vals.dtype, np.inexact):
        vals = vals.astype(np.float64)
    order = np.lexsort((rows, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
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
    return Matrix(n, indptr, rows.astype(np.int32), vals)
