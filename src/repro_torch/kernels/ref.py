"""Plain PyTorch versions of every hand-written kernel in this package.

They run for CPU tensors (the wrappers in ``level_update.py`` and
``dense_lu.py`` route CPU tensors here) and serve as the kernels' oracles on
the card.  Each repeats its kernel's arithmetic in eager PyTorch and is no
yardstick of speed.

Scatter-adds go through ``scatter_add_``: PyTorch's sorted scatter-add
under deterministic mode, so equal inputs give equal bits on the card too.
"""
from __future__ import annotations

import torch

from ..device import deterministic

__all__ = ["segmented_accumulate_ref", "dense_lu_ref", "lu_backward_error",
           "spmv_ref", "scatter_add_"]


def scatter_add_(dst, idx, src):
    """``dst[idx] += src`` in place, duplicates summed in a fixed order.
    The sorted path serialises the duplicates of one index, so callers keep
    padding (many duplicates of one slot) out of ``idx``."""
    with deterministic():
        dst.index_put_((idx,), src, accumulate=True)
    return dst


def segmented_accumulate_ref(col_vals, contribs, didx_local):
    """Per-destination-column accumulation.

    col_vals:   (D, C)  current destination-column segments
    contribs:   (D, R)  update contributions (already -l*u)
    didx_local: (D, R)  position of each contribution within its row;
                        positions outside [0, C) are dropped
    returns     (D, C)  ``col_vals`` plus the contributions, summed in
                        ascending r per destination slot
    """
    D, C = col_vals.shape
    out = col_vals.clone()
    dl = didx_local.long()
    keep = (dl >= 0) & (dl < C)
    flat = dl + torch.arange(D, device=dl.device)[:, None] * C
    scatter_add_(out.view(-1), flat[keep], contribs[keep])
    return out


def dense_lu_ref(a):
    """Unpivoted dense LU, in-place layout (L strictly below the diagonal,
    unit diagonal implied; U on and above), unblocked right-looking."""
    m = a.clone()
    n = m.shape[0]
    for j in range(n - 1):
        m[j + 1:, j] /= m[j, j]
        # an elementwise outer product (no matmul, so no TF32 on the card)
        m[j + 1:, j + 1:] -= m[j + 1:, j:j + 1] * m[j:j + 1, j + 1:]
    return m


def lu_backward_error(a, lu) -> float:
    """Componentwise backward error of an in-place-layout LU of ``a``:
    ``max |L U - A| / (|L| |U|)``, in float64 (0 where both are 0).  A
    correct LU keeps it near N times the value type's epsilon, whatever the
    size of L's entries; a wrong L does not."""
    a, lu = a.double(), lu.double()
    eye = torch.eye(a.shape[0], dtype=torch.float64, device=a.device)
    L, U = torch.tril(lu, -1) + eye, torch.triu(lu)
    den = (L.abs() @ U.abs()).clamp_min(torch.finfo(torch.float64).tiny)
    return ((L @ U - a).abs() / den).max().item()


def spmv_ref(row_ids, colidx, vals, x, n_rows):
    """COO SpMV oracle: ``y[row_ids] += vals * x[colidx]``."""
    y = torch.zeros(n_rows, dtype=vals.dtype, device=vals.device)
    return scatter_add_(y, row_ids, vals * x[colidx])
