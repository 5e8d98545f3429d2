"""Model configuration system, the JAX package's field for field.

Every architecture is a :class:`ModelConfig`; reduced smoke variants are
derived with :meth:`ModelConfig.reduced`.  Vocab sizes are padded to a
multiple of 256 (``padded_vocab``); logits and argmax run over the padded
vocab.  The distribution knobs (``attn_tp``, ``fsdp``, ``remat``,
``remat_policy``, ``scan_layers``, ``seq_shard``) are kept so that configs
compare field for field; the port's serving path does not read them.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]

VOCAB_PAD = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # --- attention ---------------------------------------------------------
    attention: str = "full"       # full | swa | mla | none
    window: int = 0               # swa window size
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0       # stablelm uses partial rotary (0.25)
    # --- MLA (deepseek-v2) ---------------------------------------------------
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- mlp -----------------------------------------------------------------
    act: str = "swiglu"           # swiglu | geglu | gelu | relu2
    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1            # apply MoE at layers where i % moe_every == moe_offset
    moe_groups: int = 0           # GShard-style local dispatch groups (0/1 = global)
    moe_offset: int = 0
    first_dense: int = 0          # first k layers always dense (deepseek)
    capacity_factor: float = 1.25
    # --- hybrid / ssm ----------------------------------------------------------
    attn_every: int = 0           # jamba: layer i is attention iff i % attn_every == attn_offset
    attn_offset: int = 0
    ssm_state: int = 0            # mamba2 d_state
    ssm_head_dim: int = 64        # mamba2 P
    ssm_expand: int = 2
    ssm_conv: int = 4
    # --- encoder-decoder ----------------------------------------------------
    encoder_layers: int = 0       # whisper
    encoder_seq: int = 0          # fixed source length (whisper: 1500)
    # --- frontends (stubs per the brief) -------------------------------------
    frontend: str = "none"        # none | audio_stub | vision_stub
    frontend_tokens: int = 0      # vision: patch tokens replacing prefix
    # --- misc -----------------------------------------------------------------
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- distribution knobs (per-arch defaults; launcher may override) -------
    attn_tp: bool = True          # shard heads over model axis
    fsdp: bool = False            # shard weight dim0 over data axis (big models)
    remat: bool = True
    remat_policy: str = "full"    # full | dots (save matmul outputs)
    scan_layers: bool = True      # lax.scan over the periodic layer pattern
    seq_shard: bool = False       # Megatron-style sequence parallelism (rules["seq"]="model")
    sub_quadratic: bool = False   # eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD

    def is_attn_layer(self, i: int) -> bool:
        if self.attention == "none":
            return False
        if self.attn_every:
            return i % self.attn_every == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.n_experts or i < self.first_dense:
            return False
        return i % self.moe_every == self.moe_offset

    def param_count(self) -> int:
        """Parameter count from the port's :func:`param_specs` (shapes only,
        nothing allocated)."""
        from ..models.model import param_specs

        return sum(math.prod(shape) for shape, _ in param_specs(self).values())

    def active_param_count(self) -> int:
        """Parameters a token uses: the routed experts' leaves count at
        ``top_k / n_experts``, the shared experts (under ``shared``) in
        full, as in the JAX package's count."""
        if not self.n_experts:
            return self.param_count()
        from ..models.model import param_specs

        frac = 1.0 - self.top_k / self.n_experts
        inactive = sum(int(math.prod(shape) * frac)
                       for name, (shape, _) in param_specs(self).items()
                       if ".experts." in name)
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        scale = {
            "num_layers": min(self.num_layers, 2 if not self.attn_every else max(2, self.attn_every)),
            "d_model": 64,
            "num_heads": 4,
            "num_kv_heads": min(self.num_kv_heads, 4) if self.num_kv_heads < self.num_heads else 4,
            "d_ff": 128,
            "vocab_size": 512,
            "head_dim": 16,
            "window": min(self.window, 32) if self.window else 0,
            "kv_lora_rank": 32 if self.kv_lora_rank else 0,
            "qk_nope_head_dim": 16 if self.qk_nope_head_dim else 0,
            "qk_rope_head_dim": 8 if self.qk_rope_head_dim else 0,
            "v_head_dim": 16 if self.v_head_dim else 0,
            "n_experts": min(self.n_experts, 4) if self.n_experts else 0,
            "top_k": min(self.top_k, 2) if self.top_k else 0,
            # dropless capacity (E/K) so smoke tests are deterministic
            "capacity_factor": (min(self.n_experts, 4) / min(self.top_k, 2))
            if self.n_experts else self.capacity_factor,
            "moe_d_ff": 64 if self.moe_d_ff else 0,
            "first_dense": min(self.first_dense, 1),
            "ssm_state": min(self.ssm_state, 16) if self.ssm_state else 0,
            "ssm_head_dim": 16 if self.ssm_state else self.ssm_head_dim,
            "encoder_layers": min(self.encoder_layers, 2),
            "encoder_seq": min(self.encoder_seq, 16) if self.encoder_seq else 0,
            "frontend_tokens": min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            "dtype": "float32",
            "fsdp": False,
            "remat": False,
        }
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
