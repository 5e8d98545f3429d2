"""The plain reference: what the answers of a window should be, from the
benchmark's own matrices and right-hand sides alone.

Plain PyTorch, on whatever device it is given.  It builds each system from
the CSC pattern and values the traffic made, and takes nothing the program
made: no plan, permutation, scaling or factor.  The program's solutions are
only read, to be judged.

- ``backward_errors``: the normwise backward error of each answer,
  ``|b - A x|_inf / (|A|_inf |x|_inf + |b|_inf)``, from a sparse product
  in the values' own precision.
- ``dense_solve``: the system solved densely with partial pivoting
  (``torch.linalg.solve``), for the forward error of a sample of answers.
"""
from __future__ import annotations

import numpy as np
import torch


def _dtype(values: np.ndarray) -> torch.dtype:
    return torch.complex128 if np.iscomplexobj(values) else torch.float64


def _coo(n: int, indptr, indices, device):
    rows = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=device)
    cols = torch.as_tensor(np.repeat(np.arange(n, dtype=np.int64),
                                     np.diff(np.asarray(indptr))), device=device)
    return rows, cols


def backward_errors(n: int, indptr, indices, values: np.ndarray,
                    b: np.ndarray, x: np.ndarray, device="cpu") -> np.ndarray:
    """(B,) normwise backward errors of (B, n) answers ``x`` to the systems
    with (B, nnz) ``values`` and (B, n) right-hand sides ``b``; NaN or inf
    answers read inf."""
    dt = _dtype(values)
    rows, cols = _coo(n, indptr, indices, device)
    a = torch.as_tensor(values, device=device).to(dt)
    bt = torch.as_tensor(b, device=device).to(dt)
    xt = torch.as_tensor(x, device=device).to(dt)
    ax = torch.zeros_like(bt).index_add_(1, rows, a * xt[:, cols])
    r = (bt - ax).abs().amax(-1)
    a_norm = torch.zeros(bt.shape, dtype=a.real.dtype, device=device
                         ).index_add_(1, rows, a.abs()).amax(-1)
    den = a_norm * xt.abs().amax(-1) + bt.abs().amax(-1)
    berr = (r / den).cpu().numpy()
    finite = torch.isfinite(xt.abs()).all(-1).cpu().numpy()
    return np.where(finite, berr, np.inf)


def dense_solve(n: int, indptr, indices, values: np.ndarray, b: np.ndarray,
                device="cpu") -> np.ndarray:
    """(B, n) solutions of the (B,) systems, one at a time (a batch of
    large systems would take the batched solver's slow route)."""
    dt = _dtype(values)
    rows, cols = _coo(n, indptr, indices, device)
    out = []
    for a, rhs in zip(values, b):
        dense = torch.zeros((n, n), dtype=dt, device=device)
        dense[rows, cols] = torch.as_tensor(a, device=device).to(dt)
        rhs = torch.as_tensor(rhs, device=device).to(dt)
        out.append(torch.linalg.solve(dense, rhs.unsqueeze(-1))[:, 0].cpu().numpy())
        del dense
    return np.stack(out)


def forward_errors(x: np.ndarray, x_ref: np.ndarray) -> np.ndarray:
    """(B,) ``|x - x_ref|_inf / |x_ref|_inf``; NaN answers read inf."""
    err = np.abs(x - x_ref).max(-1) / np.abs(x_ref).max(-1)
    return np.where(np.isfinite(err), err, np.inf)
