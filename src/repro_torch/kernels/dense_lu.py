"""K2 and K3: the unpivoted blocked dense LU of the dense trailing block.

``dense_lu(a)`` (K2) returns the in-place-layout LU of a real dense (N, N)
tile: L strictly below the diagonal (unit diagonal implied), U on and above
it.  ``dense_lu_planar(a)`` (K3) does the same for a complex tile held as
(2, N, N) re/im planes, the JAX package's interface.  A CUDA tensor runs
the hand-written kernel in ``csrc/dense_lu.cuh`` (block width ``BLOCK``):
one cooperative launch per tile that reads ``a``, writes the new tensor
and walks the block steps with grid-wide barriers; K2 from
``csrc/dense_lu.cu``, K3 from ``csrc/dense_lu_planar.cu``.  A CPU tensor
runs the plain PyTorch version in ``ref.py``.  Any other device raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import dense_lu_planar_ref, dense_lu_ref

__all__ = ["dense_lu", "dense_lu_planar", "BLOCK"]

BLOCK = 32   # kB in csrc/dense_lu.cuh: N must be a multiple of it

_ENTRY = {torch.float32: "glu_dense_lu_f32", torch.float64: "glu_dense_lu_f64"}
_PLANAR_ENTRY = {torch.float32: "glu_dense_lu_planar_f32",
                 torch.float64: "glu_dense_lu_planar_f64"}


def _launch(entry: str, a: torch.Tensor, N: int, what: str) -> torch.Tensor:
    """Factor ``a`` into a new tensor on the caller's stream."""
    a = a.contiguous()
    out = torch.empty_like(a)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, entry)(a.data_ptr(), out.data_ptr(), N, stream)
    _build.check(rc, what)
    return out


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
    out = _launch(_ENTRY[a.dtype], a, a.shape[0], "dense_lu")
    dense_lu.launches += 1
    return out


dense_lu.launches = 0


def dense_lu_planar(a: torch.Tensor) -> torch.Tensor:
    """K3: ``a`` is (2, N, N) float32 or float64 re/im planes of a complex64
    or complex128 tile; returns new planes, ``a`` is not modified."""
    dev = a.device
    if dev.type == "cpu":
        return dense_lu_planar_ref(a)
    if dev.type != "cuda":
        raise ValueError(f"dense_lu_planar runs on cuda or cpu, not {dev}")
    if a.dtype not in _PLANAR_ENTRY:
        raise TypeError(f"dense_lu_planar takes float32 or float64 planes, "
                        f"got {a.dtype}")
    if a.dim() != 3 or a.shape[0] != 2 or a.shape[1] != a.shape[2] \
            or a.shape[1] % BLOCK:
        raise ValueError(f"dense_lu_planar needs (2, N, N) planes with N a "
                         f"multiple of {BLOCK}, got {tuple(a.shape)}")
    out = _launch(_PLANAR_ENTRY[a.dtype], a, a.shape[1], "dense_lu_planar")
    dense_lu_planar.launches += 1
    return out


dense_lu_planar.launches = 0
