"""Whisper-base [arXiv:2212.04356; unverified].

Encoder-decoder, 6+6L, d_model 512, 8 heads (MHA), GELU d_ff=2048,
LayerNorm, vocab 51865 (padded to 51968).  Conv audio frontend is a STUB:
the caller supplies frame embeddings (B, 1500, d_model) as
``extras["frames"]``.
Decoder "seq_len" follows the assigned LM shapes; long_500k skipped
(quadratic decoder).  74M parameters.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    encoder_layers=6,
    encoder_seq=1500,
    frontend="audio_stub",
    attn_tp=False,
)
