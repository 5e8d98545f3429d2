"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "deterministic"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA request without a card raises: the
    port never falls back to the CPU on its own; pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def deterministic():
    """Run the block with ``torch.use_deterministic_algorithms(True)`` and
    restore the caller's setting after: ``index_put_(accumulate=True)`` then
    takes PyTorch's sorted, fixed-order path on the card."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
