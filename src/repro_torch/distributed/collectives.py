"""Explicit reductions across the shards of a scenario sweep.

The JAX package's ``psum_exact`` runs inside ``shard_map``: one process
drives every device and the psum sums the shards' values.  Here the same
process holds each shard's tensor on its own device, so the exact sum is a
gather of the (small) per-shard tensors onto the first shard's device and
an integer add there.  The training helpers of the JAX package's module
(``compressed_psum``, ``quantize_int8``, ``fake_quantize_grads``) are not
part of the solver and are not here.
"""
from __future__ import annotations

import torch

__all__ = ["psum_exact"]


def psum_exact(parts) -> torch.Tensor:
    """Elementwise sum of per-shard integer tensors, in int64 on the first
    shard's device: for small diagnostics (static-pivot bump counts, ladder
    tallies) where the sum must be exact.  Every part has the same shape;
    floating-point parts raise ``TypeError``."""
    parts = list(parts)
    if not parts:
        raise ValueError("psum_exact needs at least one shard's tensor")
    shape = parts[0].shape
    for p in parts:
        if p.is_floating_point() or p.is_complex():
            raise TypeError(f"psum_exact sums integer tensors, got {p.dtype}")
        if p.shape != shape:
            raise ValueError(f"psum_exact needs equal shapes, got "
                             f"{tuple(shape)} and {tuple(p.shape)}")
    dev = parts[0].device
    total = parts[0].to(torch.int64)
    for p in parts[1:]:
        total = total + p.to(device=dev, dtype=torch.int64)
    return total
