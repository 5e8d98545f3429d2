"""The LM template stack's models for every family (dense, moe, vlm,
audio, hybrid, ssm) in plain PyTorch."""
from . import layers, model
from .model import (
    LM,
    cache_axes,
    cache_specs,
    forward_decode,
    forward_prefill,
    forward_train,
    init_params,
    lm_head_of,
    param_axes,
    param_specs,
)

__all__ = [
    "layers",
    "model",
    "LM",
    "cache_axes",
    "cache_specs",
    "forward_decode",
    "forward_prefill",
    "forward_train",
    "init_params",
    "lm_head_of",
    "param_axes",
    "param_specs",
]
