"""K2: the unpivoted blocked dense LU of the dense trailing block.

``dense_lu(a)`` returns the in-place-layout LU of a dense (N, N) tile: L
strictly below the diagonal (unit diagonal implied), U on and above it.  A
CUDA tensor runs the hand-written kernels in ``csrc/dense_lu.cu`` (block
width ``BLOCK``; per block step one diagonal-block factor, one panel solve
and one tiled trailing update, all issued by one C call); a CPU tensor runs
the plain PyTorch version in ``ref.py``.  Any other device raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import dense_lu_ref

__all__ = ["dense_lu", "BLOCK"]

BLOCK = 32   # kB in csrc/dense_lu.cu: N must be a multiple of it

_ENTRY = {torch.float32: "glu_dense_lu_f32", torch.float64: "glu_dense_lu_f64"}


def dense_lu(a: torch.Tensor) -> torch.Tensor:
    """Returns a new (N, N) tensor; ``a`` is not modified."""
    dev = a.device
    if dev.type == "cpu":
        return dense_lu_ref(a)
    if dev.type != "cuda":
        raise ValueError(f"dense_lu runs on cuda or cpu, not {dev}")
    if a.dtype not in _ENTRY:
        raise TypeError(f"dense_lu takes float32 or float64, got {a.dtype}")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or a.shape[0] % BLOCK:
        raise ValueError(f"dense_lu needs a square tile whose side is a "
                         f"multiple of {BLOCK}, got {tuple(a.shape)}")
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    out.copy_(a)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _ENTRY[a.dtype])(out.data_ptr(), a.shape[0], stream)
    _build.check(rc, "dense_lu")
    dense_lu.launches += 1
    return out


dense_lu.launches = 0
