"""Nemotron-4-340B [arXiv:2402.16819; unverified].

96L dense decoder, GQA (96 q heads, 8 kv), squared-ReLU MLP (no gating),
d_ff = 4 * d_model, vocab 256000.  Largest assigned arch.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    act="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
    fsdp=True,
    remat_policy="dots",
    seq_shard=True,
)
