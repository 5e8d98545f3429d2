"""K2 and K3: the unpivoted blocked dense LU of the dense trailing block.

``dense_lu(a)`` (K2) returns the in-place-layout LU of a real dense (N, N)
tile: L strictly below the diagonal (unit diagonal implied), U on and above
it.  ``dense_lu_planar(a)`` (K3) does the same for a complex tile held as
(2, N, N) re/im planes, the JAX package's interface.  Both also take a
leading batch axis, (B, N, N) and (B, 2, N, N): B tiles of one N, the
batched engine's dense tails (the JAX package vmaps its XLA LU there).  A
CUDA tensor runs the hand-written kernel in ``csrc/dense_lu.cuh`` (block
width ``BLOCK``): one cooperative launch per tile or per batch of tiles
that reads ``a``, writes the new tensor and walks the block steps with
grid-wide barriers; K2 from ``csrc/dense_lu.cu``, K3 from
``csrc/dense_lu_planar.cu``.  A CPU tensor runs the plain PyTorch version
in ``ref.py``.  Any other device raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import dense_lu_planar_ref, dense_lu_ref

__all__ = ["dense_lu", "dense_lu_planar", "BLOCK"]

BLOCK = 32   # kB in csrc/dense_lu.cuh: N must be a multiple of it

_TYPES = {torch.float32: "f32", torch.float64: "f64"}


def _launch(entry: str, a: torch.Tensor, N: int, planes: int,
            what: str) -> torch.Tensor:
    """Factor the tile(s) of ``a`` into a new tensor on the caller's
    stream: the single-tile entry for an unbatched ``a``, the batched one
    (one launch for all tiles) otherwise."""
    batched = a.dim() == 3 + (planes == 2)
    a = a.contiguous()
    out = torch.empty_like(a)
    batch = a.shape[0] if batched else 1
    # the diagonal blocks between phases: BLOCK^2 values a plane and tile
    carry = torch.empty(batch * planes * BLOCK * BLOCK, dtype=a.dtype,
                        device=a.device)
    name = f"{entry}{'_batched' if batched else ''}_{_TYPES[a.dtype]}"
    fn = getattr(_build.load_library(), name)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        args = (N, batch) if batched else (N,)
        rc = fn(a.data_ptr(), out.data_ptr(), carry.data_ptr(), *args, stream)
    _build.check(rc, what)
    return out


def dense_lu(a: torch.Tensor) -> torch.Tensor:
    """Returns a new (N, N) or (B, N, N) tensor; ``a`` is not modified."""
    dev = a.device
    if dev.type == "cpu":
        return dense_lu_ref(a)
    if dev.type != "cuda":
        raise ValueError(f"dense_lu runs on cuda or cpu, not {dev}")
    if a.dtype not in _TYPES:
        raise TypeError(f"dense_lu takes float32 or float64, got {a.dtype}")
    if a.dim() not in (2, 3) or a.shape[-1] != a.shape[-2] \
            or a.shape[-1] % BLOCK:
        raise ValueError(f"dense_lu needs square (N, N) or (B, N, N) tiles "
                         f"whose side is a multiple of {BLOCK}, got "
                         f"{tuple(a.shape)}")
    out = _launch("glu_dense_lu", a, a.shape[-1], 1, "dense_lu")
    _build.count_launch(dense_lu)
    return out


dense_lu.launches = 0
dense_lu.captured = 0


def dense_lu_planar(a: torch.Tensor) -> torch.Tensor:
    """K3: ``a`` is (2, N, N) float32 or float64 re/im planes of a complex64
    or complex128 tile, or (B, 2, N, N) for B tiles; returns new planes,
    ``a`` is not modified."""
    dev = a.device
    if dev.type == "cpu":
        return dense_lu_planar_ref(a)
    if dev.type != "cuda":
        raise ValueError(f"dense_lu_planar runs on cuda or cpu, not {dev}")
    if a.dtype not in _TYPES:
        raise TypeError(f"dense_lu_planar takes float32 or float64 planes, "
                        f"got {a.dtype}")
    if a.dim() not in (3, 4) or a.shape[-3] != 2 \
            or a.shape[-1] != a.shape[-2] or a.shape[-1] % BLOCK:
        raise ValueError(f"dense_lu_planar needs (2, N, N) or (B, 2, N, N) "
                         f"planes with N a multiple of {BLOCK}, got "
                         f"{tuple(a.shape)}")
    out = _launch("glu_dense_lu_planar", a, a.shape[-1], 2, "dense_lu_planar")
    _build.count_launch(dense_lu_planar)
    return out


dense_lu_planar.launches = 0
dense_lu_planar.captured = 0
