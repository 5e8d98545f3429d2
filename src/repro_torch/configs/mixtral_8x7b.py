"""Mixtral-8x7B [arXiv:2401.04088; hf-verified].

32L, GQA 32 q / 8 kv, 8 experts top-2 SwiGLU d_ff=14336, RMSNorm,
sliding-window attention (brief: SWA; window 4096) -> KV cache bounded by
the window, decode is O(window): long_500k eligible with a rolling-buffer
cache.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attention="swa",
    window=4096,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    fsdp=True,
    sub_quadratic=True,
    moe_groups=16,
    seq_shard=True,
)
