"""The LM template stack's models for the families without a Mamba-2
block (dense, moe, vlm, audio) in plain PyTorch."""
from . import layers, model
from .model import (
    LM,
    cache_specs,
    forward_decode,
    forward_prefill,
    forward_train,
    init_params,
    lm_head_of,
    param_specs,
)

__all__ = [
    "layers",
    "model",
    "LM",
    "cache_specs",
    "forward_decode",
    "forward_prefill",
    "forward_train",
    "init_params",
    "lm_head_of",
    "param_specs",
]
