"""PyTorch port, the LM configs: the ten architectures and their reduced
forms field for field the JAX package's, the registry's helpers, the
parameter counts (total and active) of every family at full size (shapes
only, nothing allocated)."""
import dataclasses

import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
ARCHS = jconfigs.list_archs()
PORTED = ["qwen2.5-3b", "stablelm-1.6b", "stablelm-3b", "nemotron-4-340b",
          "phi-3-vision-4.2b", "whisper-base", "deepseek-v2-lite-16b",
          "mixtral-8x7b", "mamba2-2.7b", "jamba-v0.1-52b"]


def test_registry_matches_reference():
    assert tconfigs.list_archs() == ARCHS and len(ARCHS) == 10
    assert sorted(PORTED) == ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.get_config("stablelm_3b") is tconfigs.get_config("stablelm-3b")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")
    assert tconfigs.CONFIG == tconfigs.GLUConfig()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    got, want = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert tconfigs.shape_cells(arch) == jconfigs.shape_cells(arch)
    for cfg, ref in ((got, want), (got.reduced(), want.reduced())):
        assert (cfg.hd, cfg.padded_vocab) == (ref.hd, ref.padded_vocab)
        assert [cfg.is_attn_layer(i) for i in range(cfg.num_layers)] == \
            [ref.is_attn_layer(i) for i in range(ref.num_layers)]
        assert [cfg.is_moe_layer(i) for i in range(cfg.num_layers)] == \
            [ref.is_moe_layer(i) for i in range(ref.num_layers)]


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_reference(arch):
    cfg = tconfigs.get_config(arch)
    assert cfg.param_count() == jconfigs.get_config(arch).param_count()
    assert cfg.reduced().param_count() == jconfigs.get_config(arch).reduced().param_count()
    assert cfg.active_param_count() == jconfigs.get_config(arch).active_param_count()


def test_qwen_param_count():
    cfg = tconfigs.get_config("qwen2.5-3b")
    assert cfg.param_count() == 3_086_200_832
    assert cfg.padded_vocab == 152_064


# (arch, num_layers or None for the published depth) -> (params, active):
# the reference's param_count() / active_param_count()
ACTIVE = {("deepseek-v2-lite-16b", None): (15_708_450_304, 2_663_116_288),
          ("mixtral-8x7b", None): (46_702_792_704, 12_879_925_248),
          ("mixtral-8x7b", 8): (11_872_309_248, 3_416_592_384),
          ("mamba2-2.7b", None): (2_832_074_240, 2_832_074_240),
          ("jamba-v0.1-52b", None): (51_460_000_640, 11_999_988_608),
          ("jamba-v0.1-52b", 8): (13_267_656_416, 3_402_653_408)}


@pytest.mark.parametrize("arch,layers", list(ACTIVE))
def test_active_param_count(arch, layers):
    """The MoE and Mamba families at full width: routed experts count at
    top_k / E, deepseek's two shared experts in full (mixtral and jamba at
    8 of their 32 layers are the depths the card serves)."""
    cfg = tconfigs.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    assert (cfg.param_count(), cfg.active_param_count()) == ACTIVE[arch, layers]
    dense = tconfigs.get_config("qwen2.5-3b")
    assert dense.active_param_count() == dense.param_count()
