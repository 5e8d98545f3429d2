"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf family].

phi3-mini backbone: 32L, d_model 3072, MHA 32 heads, SwiGLU d_ff=8192,
RMSNorm, vocab 32064 (padded 32256).  CLIP vision frontend is a STUB:
the caller supplies patch embeddings (B, 1024 [here 256], d_model) as
``extras["patch_embeds"]``; they replace the first ``frontend_tokens``
positions of the sequence.  Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    act="swiglu",
    norm="rmsnorm",
    frontend="vision_stub",
    frontend_tokens=256,
    seq_shard=True,
)
