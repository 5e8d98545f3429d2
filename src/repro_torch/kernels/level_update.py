"""K1: the segmented level update (GLU's submatrix update for the narrow
SEGMENTED/PANEL levels).

``segmented_accumulate(col_vals, contribs, didx_local)`` computes
``col_vals (D, C) + scatter(contribs (D, R) at didx_local (D, R))``: each
row is one destination column segment of a level, positions outside
``[0, C)`` are dropped and duplicate positions sum.  A CUDA tensor launches
the hand-written kernel in ``csrc/segmented_accumulate.cu`` (one CTA per row
and 1024-slot block, a counting sort of each tile into slot buckets, sums in
a fixed order: deterministic); a CPU tensor runs the plain PyTorch version
in ``ref.py``.  Any other device raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import segmented_accumulate_ref

__all__ = ["segmented_accumulate"]

_ENTRY = {torch.float32: "glu_segmented_accumulate_f32",
          torch.float64: "glu_segmented_accumulate_f64"}


def segmented_accumulate(col_vals: torch.Tensor, contribs: torch.Tensor,
                         didx_local: torch.Tensor) -> torch.Tensor:
    """Returns a new (D, C) tensor; the inputs are not modified."""
    dev = col_vals.device
    if dev.type == "cpu":
        return segmented_accumulate_ref(col_vals, contribs, didx_local)
    if dev.type != "cuda":
        raise ValueError(f"segmented_accumulate runs on cuda or cpu, not {dev}")
    if contribs.device != dev or didx_local.device != dev:
        raise ValueError("col_vals, contribs and didx_local must share a device")
    if col_vals.dtype not in _ENTRY or contribs.dtype != col_vals.dtype:
        raise TypeError(f"expected float32 or float64 values of one dtype, got "
                        f"{col_vals.dtype} and {contribs.dtype}")
    if didx_local.dtype != torch.int32:
        raise TypeError(f"didx_local must be int32, got {didx_local.dtype}")
    if col_vals.dim() != 2 or contribs.dim() != 2 or \
            didx_local.shape != contribs.shape or \
            contribs.shape[0] != col_vals.shape[0]:
        raise ValueError(f"expected (D, C), (D, R), (D, R); got "
                         f"{tuple(col_vals.shape)}, {tuple(contribs.shape)}, "
                         f"{tuple(didx_local.shape)}")
    if not (col_vals.is_contiguous() and contribs.is_contiguous()
            and didx_local.is_contiguous()):
        raise ValueError("segmented_accumulate needs contiguous tensors")
    D, C = col_vals.shape
    R = contribs.shape[1]
    out = torch.empty_like(col_vals)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _ENTRY[col_vals.dtype])(
            col_vals.data_ptr(), contribs.data_ptr(), didx_local.data_ptr(),
            out.data_ptr(), D, C, R, stream)
    _build.check(rc, "segmented_accumulate")
    segmented_accumulate.launches += 1
    return out


segmented_accumulate.launches = 0
