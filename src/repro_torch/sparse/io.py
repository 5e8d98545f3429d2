"""MatrixMarket I/O, so real UFL/SuiteSparse matrices drop into the solver.

The parser rules are the JAX package's: a ``.gz`` path is read through
gzip, ``symmetric`` files have their strictly off-diagonal entries
mirrored, ``pattern`` files read as ones, non-square matrices are refused,
and duplicates are summed.  Values are written with ``%.17g`` (a float64
round-trips exactly).
"""
from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from .csc import CSC, csc_from_coo

__all__ = ["read_matrix_market", "write_matrix_market"]


def _open(path):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path, "r")


def read_matrix_market(path) -> CSC:
    """A square real MatrixMarket ``coordinate`` file as a :class:`CSC`."""
    with _open(path) as f:
        header = f.readline().strip().lower()
        if not header.startswith("%%matrixmarket"):
            raise ValueError(f"not a MatrixMarket file: {header!r}")
        fields = header.split()
        symmetric = "symmetric" in fields
        pattern = "pattern" in fields
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(x) for x in line.split())
        if nrows != ncols:
            raise ValueError("only square matrices supported")
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.empty(nnz, dtype=np.float64)
        for k in range(nnz):
            parts = f.readline().split()
            rows[k] = int(parts[0]) - 1
            cols[k] = int(parts[1]) - 1
            vals[k] = 1.0 if pattern else float(parts[2])
    if symmetric:
        # mirror the strictly off-diagonal entries
        off = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    return csc_from_coo(nrows, rows, cols, vals)


def write_matrix_market(path, A: CSC) -> None:
    """``A`` as a real general MatrixMarket ``coordinate`` file."""
    rows, cols, vals = A.to_coo()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{A.n} {A.n} {len(rows)}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")
