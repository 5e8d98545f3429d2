"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b; unverified].

24L dense decoder, MHA 32 heads, partial rotary 25%, LayerNorm,
SwiGLU d_ff=5632, vocab 100352.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    act="swiglu",
    norm="layernorm",
    rotary_pct=0.25,
    seq_shard=True,
)
