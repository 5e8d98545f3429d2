"""StableLM-2 3B-class [hf:stabilityai/stablelm-2-1_6b scaled; unverified].

32L dense decoder, MHA (kv == heads == 32), partial rotary (25%),
LayerNorm, SwiGLU d_ff=6912, vocab 50304.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    act="swiglu",
    norm="layernorm",
    rotary_pct=0.25,
    rope_theta=10_000.0,
    seq_shard=True,
)
