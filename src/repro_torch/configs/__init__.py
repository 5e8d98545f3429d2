"""Configurations: the solver's own (``CONFIG``, a :class:`GLUConfig`) and
the LM architecture registry (``get_config(arch_id)`` / ``list_archs()``),
the JAX package's ten configs field for field.  The port serves every
family (dense, moe, vlm, audio, and the Mamba-2 ones: hybrid, ssm)."""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeSpec
from .deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from .glu_paper import CONFIG, GLUConfig
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from .mamba2_2_7b import CONFIG as mamba2_2_7b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .nemotron_4_340b import CONFIG as nemotron_4_340b
from .phi_3_vision_4_2b import CONFIG as phi_3_vision_4_2b
from .qwen2_5_3b import CONFIG as qwen2_5_3b
from .stablelm_1_6b import CONFIG as stablelm_1_6b
from .stablelm_3b import CONFIG as stablelm_3b
from .whisper_base import CONFIG as whisper_base

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        nemotron_4_340b,
        stablelm_3b,
        qwen2_5_3b,
        stablelm_1_6b,
        jamba_v0_1_52b,
        whisper_base,
        deepseek_v2_lite_16b,
        mixtral_8x7b,
        phi_3_vision_4_2b,
        mamba2_2_7b,
    ]
}


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("_", "-")
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[key]


def list_archs() -> list[str]:
    return sorted(REGISTRY)


def shape_cells(arch: str) -> list[str]:
    """The dry-run cells defined for this arch."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


__all__ = [
    "CONFIG",
    "GLUConfig",
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
    "REGISTRY",
    "get_config",
    "list_archs",
    "shape_cells",
]
