"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf-verified].

27L, MLA attention (kv_lora_rank=512, qk_nope 128 + qk_rope 64, v 128),
MoE with 64 routed experts top-6 + 2 shared experts, moe_d_ff=1408,
first layer dense (d_ff 10944 ~ brief's d_ff field covers the MoE expert
width; the dense first layer uses 8 * moe_d_ff).  Full (quadratic) MLA
attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,            # dense first-layer FFN width (8 * 1408)
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense=1,
    fsdp=True,
    moe_groups=16,
    seq_shard=True,
)
