"""Jamba-v0.1 52B [arXiv:2403.19887; hf-verified].

32L hybrid: attention every 8th layer (1:7 attn:mamba), MoE (16 experts,
top-2) every other layer.  GQA 32 q / 8 kv on attention layers; Mamba
(SSM) layers carry long context -> sub-quadratic, long_500k eligible.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    act="swiglu",
    norm="rmsnorm",
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    fsdp=True,
    sub_quadratic=True,
    moe_groups=16,
    seq_shard=True,
)
