"""Step functions around the kernels, in the single-matrix forms.

``level_update_body`` is the plain per-level step of a SEGMENTED/PANEL
level on the JAX package's padded (D, R, C) segmented layout: normalize,
gather the operands, accumulate the contributions per destination column
with ``segmented_accumulate`` (the TPU kernel's function) and write the
segments back.  ``level_update_planar_body`` is its complex twin on the
re/im plane view, with the plane axis folded into the accumulation's rows.
They run on CPU tensors and hold the run kernel's plain version to the
per-level route (tests); on the card a run of such levels is one launch of
K1 ``level_run`` (``level_update.py``).

The padded layout carries one trash slot past the real values
(``vals[nnz]``): every padded index points there, so padded reads and
writes stay inside the trash slot, and the accumulation drops padded
positions itself.  Scatter-adds outside K1 run in fixed-order rounds of
distinct targets (``round_order`` / ``add_in_rounds_``, in ``ref.py``).
``perturb_diags`` (in ``ref.py``, the reference's ``_perturb_diags_body``)
is the static pivot bump of the flat levels and the dense tail; a K1 run
bumps its levels inside the kernel.
"""
from __future__ import annotations

import torch

from ..sparse.layout import pdiv, pmul
from .level_update import segmented_accumulate
from .ref import add_in_rounds_, perturb_diags, round_order, spmv_ref

__all__ = ["level_update_body", "level_update_planar_body", "spmv",
           "factor_stats", "factor_stats_batched", "masked_correction",
           "round_order", "add_in_rounds_", "perturb_diags",
           "perturb_diags_batched"]


def level_update_body(vals, norm_idx, norm_diag, lidx2d, uidx2d, didx_local,
                      col_positions):
    """One GLU level on the padded segmented layout, in place on ``vals``.

    vals:          (nnz + 1,) filled values, trash slot last
    norm_idx/diag: (Pn,)  flat normalisation indices of the level
    lidx2d/uidx2d: (D, R) value indices of each update's L and U operand
    didx_local:    (D, R) int32 position of each update inside its
                          destination segment (padded with C)
    col_positions: (D, C) flat value indices of the destination segments
                          (padded with nnz)
    """
    vals[norm_idx] = vals[norm_idx] / vals[norm_diag]
    contribs = -(vals[lidx2d] * vals[uidx2d])
    out = segmented_accumulate(vals[col_positions], contribs, didx_local)
    vals[col_positions] = out
    return vals


def level_update_planar_body(vals, norm_idx, norm_diag, lidx2d, uidx2d,
                             didx_local, col_positions):
    """Planar twin of :func:`level_update_body` for complex ``vals``
    (complex64/complex128, trash slot last), in place.  It normalises with
    :func:`pdiv`, forms the contributions with :func:`pmul`, folds the
    re/im plane axis into the accumulation's rows (contributions
    ``(2·D, R)``, segments ``(2·D, C)``), accumulates once and writes both
    planes back.  The planes
    accumulate independently: the complex cross terms are all in ``pmul``,
    before the scatter.

    Gathers and writes index the complex tensor itself, one element per
    index, and only their results are viewed as planes: indexing rows of
    the ``(nnz + 1, 2)`` plane view takes PyTorch's row-gather kernel,
    which cost 15 ms of a 19 ms rajat12_ac factorization on an H100
    (PERF.md)."""
    planes = torch.view_as_real
    D, R = lidx2d.shape
    C = col_positions.shape[1]
    norm = pdiv(planes(vals[norm_idx]), planes(vals[norm_diag]))
    vals[norm_idx] = torch.view_as_complex(norm)
    contribs = -pmul(planes(vals[lidx2d]), planes(vals[uidx2d]))
    contribs = contribs.movedim(-1, 0).reshape(2 * D, R)
    cv = planes(vals[col_positions]).movedim(-1, 0).reshape(2 * D, C)
    dl = didx_local.expand(2, D, R).reshape(2 * D, R)
    out = segmented_accumulate(cv, contribs, dl).view(2, D, C)
    vals[col_positions] = torch.complex(out[0], out[1])
    return vals


# COO SpMV for refinement's residual: a row of A has many entries, so one
# sorted deterministic scatter-add beats rounds of distinct rows
spmv = spmv_ref


def factor_stats(vals, diag_idx, a_max):
    """Element pivot growth ``max|LU| / max|A|`` and the smallest factored
    diagonal magnitude, as 0-d tensors; complex values reduce magnitudes.
    A batch, (B, nnz) values and (B,) ``a_max``, gives (B,) tensors, each
    matrix's as alone."""
    mag = vals.abs()
    tiny = torch.finfo(mag.dtype).tiny
    growth = mag.amax(-1) / torch.clamp(a_max, min=tiny)
    return growth, mag[..., diag_idx].amin(-1)


def masked_correction(x, d, berr, tol: float):
    """``x + d`` while the solve is above tolerance, ``x`` once it has
    converged: the convergence mask stays on the device, so refinement
    sweeps need no host sync each.  ``berr`` is 0-d for one solve, (B,)
    for a batch of (B, n) solves (each row masked by its own)."""
    mask = (berr > tol).reshape(berr.shape + (1,) * (x.dim() - berr.dim()))
    return x + torch.where(mask, d, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


# the reference's batched names: the functions above and ``perturb_diags``
# take a leading batch axis themselves
factor_stats_batched = factor_stats
perturb_diags_batched = perturb_diags
