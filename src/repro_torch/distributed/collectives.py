"""Explicit reductions across shards, and int8 gradient compression.

The JAX package's collectives run inside ``shard_map``: one process drives
every device and a psum sums the shards' values.  Here the same process
holds each shard's tensor on its own device, so a sum is a gather of the
per-shard tensors onto the first shard's device and an add there.

* ``psum_exact`` sums small integer diagnostics (static-pivot bumps,
  ladder tallies) exactly, in int64.
* ``compressed_psum`` is the int8-compressed gradient sum: each shard is
  quantised to int8 with its own amax scale, the small integers are summed
  in int32 (no overflow across more than 127 shards) and the sum is
  dequantised with the largest scale, the JAX package's rule (a ``psum``
  of the integers, a ``pmax`` of the scales).
* ``fake_quantize_grads`` applies the same quantisation numerics to one
  shard's gradients in place of the wire: it models what compression does
  to training accuracy without a reduction.  On one shard
  ``compressed_psum`` is its float32 result.
"""
from __future__ import annotations

import torch

__all__ = ["psum_exact", "compressed_psum", "fake_quantize_grads",
           "quantize_int8", "dequantize_int8"]


def psum_exact(parts) -> torch.Tensor:
    """Elementwise sum of per-shard integer tensors, in int64 on the first
    shard's device: for small diagnostics (static-pivot bump counts, ladder
    tallies) where the sum must be exact.  Every part has the same shape;
    floating-point parts raise ``TypeError``."""
    parts = _shards(parts, "psum_exact")
    for p in parts:
        if p.is_floating_point() or p.is_complex():
            raise TypeError(f"psum_exact sums integer tensors, got {p.dtype}")
    dev = parts[0].device
    total = parts[0].to(torch.int64)
    for p in parts[1:]:
        total = total + p.to(device=dev, dtype=torch.int64)
    return total


def _shards(parts, who: str) -> list:
    parts = list(parts)
    if not parts:
        raise ValueError(f"{who} needs at least one shard's tensor")
    shape = parts[0].shape
    for p in parts:
        if p.shape != shape:
            raise ValueError(f"{who} needs equal shapes, got "
                             f"{tuple(shape)} and {tuple(p.shape)}")
    return parts


def quantize_int8(x: torch.Tensor):
    """(int8 values, float32 0-d scale): ``scale = max|x| / 127 + 1e-30``,
    ``q = clip(round(x / scale), -127, 127)`` with round half to even."""
    x = x.float()
    scale = x.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(parts) -> torch.Tensor:
    """int8-compressed sum of per-shard float tensors, float32 on the first
    shard's device: each shard quantised with its own scale, the int8
    values summed in int32, the sum times the largest scale."""
    parts = _shards(parts, "compressed_psum")
    dev = parts[0].device
    total, smax = None, None
    for p in parts:
        q, scale = quantize_int8(p)
        q, scale = q.to(device=dev, dtype=torch.int32), scale.to(dev)
        total = q if total is None else total + q
        smax = scale if smax is None else torch.maximum(smax, scale)
    return total.float() * smax


def fake_quantize_grads(grads):
    """``dequantize(quantize(g))`` cast back to each gradient's dtype, over
    a dict (or list) of tensors; the same structure comes back."""
    def leaf(g):
        return dequantize_int8(*quantize_int8(g)).to(g.dtype)

    if isinstance(grads, dict):
        return {k: leaf(g) for k, g in grads.items()}
    return [leaf(g) for g in grads]
