"""Qwen2.5-3B [hf:Qwen/Qwen2.5 series; hf-verified family].

36L dense decoder, GQA 16 q / 2 kv heads, QKV bias, SwiGLU d_ff=11008,
RMSNorm, rope_theta 1e6, tied embeddings, vocab 151936 (padded 152064).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    seq_shard=True,
)
