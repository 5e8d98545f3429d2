"""Mamba2-2.7B [arXiv:2405.21060; unverified].

64L attention-free SSM (SSD / state-space duality), d_model 2560,
d_state 128, expand 2 (d_inner 5120), head dim 64 -> 80 ssm heads,
conv4 depthwise frontend per block, vocab 50280 (padded 50432).
Fully sub-quadratic -> long_500k eligible.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,          # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    norm="rmsnorm",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    sub_quadratic=True,
)
