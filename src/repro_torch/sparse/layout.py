"""Value-storage layouts for the numeric executors.

* ``native``: values are stored in their logical dtype.
* ``planar``: complex values run through the kernels as split real and
  imaginary planes, a trailing axis of size 2 (``[..., 0]`` = re,
  ``[..., 1]`` = im).  The kernels take only real operands: the complex
  multiply is 4 real products and a sign, the reciprocal
  ``conj(d) / (re^2 + im^2)``.

The port stores complex factor values as a ``torch.complex64`` /
``complex128`` tensor.  ``torch.view_as_real`` of it is, byte for byte and
without a copy, the JAX package's planar ``(nnz, 2)`` array, so "planar"
here means that the kernel steps run on that view; callers always see
native complex.  Gathers and scatters on a ``(nnz, 2)`` view index rows,
so the same plan index arrays drive both layouts.

Numerical contract: :func:`pdiv` is the textbook ``a * conj(b) / |b|^2``,
as in the JAX package.  PyTorch's own complex ``/`` scales the divisor
first (Smith's method), so it rounds differently and the two agree to
tolerance, not to bits.  ``pdiv`` does not guard ``|b|^2`` against
overflow: fine for the MC64-scaled values it is used on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "ValueLayout",
    "resolve_layout",
    "pack_planes",
    "unpack_planes",
    "pmul",
    "pdiv",
    "pabs",
]

_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_NUMPY = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
          np.dtype(np.complex64): torch.complex64,
          np.dtype(np.complex128): torch.complex128}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    nd = np.dtype(dtype)
    if nd not in _NUMPY:
        raise TypeError(f"unsupported value dtype {nd}")
    return _NUMPY[nd]


@dataclasses.dataclass(frozen=True)
class ValueLayout:
    """How factor values of one logical ``dtype`` run through the kernels."""

    name: str               # "native" | "planar"
    dtype: torch.dtype      # logical value dtype (what callers see)

    @property
    def planar(self) -> bool:
        return self.name == "planar"

    @property
    def storage_dtype(self) -> torch.dtype:
        """dtype of the kernels' operands: the re/im plane dtype for planar
        complex, the logical dtype otherwise."""
        return _REAL_OF[self.dtype] if self.planar else self.dtype

    def storage_shape(self, *leading) -> tuple:
        """Shape of the plane view of a logical ``(*leading,)`` array."""
        return tuple(leading) + ((2,) if self.planar else ())


def resolve_layout(layout, dtype) -> ValueLayout:
    """``"auto"`` picks ``planar`` for complex dtypes and ``native`` for
    real ones; ``"planar"`` on a real dtype raises (real values have no
    imaginary plane to split)."""
    if isinstance(layout, ValueLayout):
        layout = layout.name
    dt = _torch_dtype(dtype)
    if layout == "auto":
        layout = "planar" if dt.is_complex else "native"
    if layout not in ("native", "planar"):
        raise ValueError(
            f"layout must be 'native', 'planar' or 'auto', got {layout!r}")
    if layout == "planar" and not dt.is_complex:
        raise ValueError(
            f"layout='planar' requires a complex dtype, got {dt} "
            f"(real values have no imaginary plane)")
    return ValueLayout(layout, dt)


def pack_planes(x: torch.Tensor, storage_dtype=None) -> torch.Tensor:
    """Logical (complex or real) tensor -> ``(..., 2)`` re/im planes.  A
    complex tensor in its own plane dtype comes back as a view."""
    if x.is_complex():
        p = torch.view_as_real(x.resolve_conj())
    else:
        p = torch.stack([x, torch.zeros_like(x)], dim=-1)
    return p if storage_dtype is None else p.to(_torch_dtype(storage_dtype))


def unpack_planes(x: torch.Tensor) -> torch.Tensor:
    """``(..., 2)`` re/im planes -> native complex tensor."""
    return torch.complex(x[..., 0], x[..., 1])


def pmul(a, b):
    """Planar complex multiply: 4 real multiplies and a sign on (..., 2)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def pdiv(a, b):
    """Planar complex divide: multiply by conj(b), scale by 1/(re^2+im^2)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    inv = 1.0 / (br * br + bi * bi)
    return torch.stack([(ar * br + ai * bi) * inv,
                        (ai * br - ar * bi) * inv], dim=-1)


def pabs(a):
    """Planar complex magnitude: hypot over the trailing plane axis."""
    return torch.hypot(a[..., 0], a[..., 1])
