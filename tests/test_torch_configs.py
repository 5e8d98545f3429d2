"""PyTorch port, the LM configs: the ten architectures and their reduced
forms field for field the JAX package's, the registry's helpers, the
parameter counts of the ported families at full size (shapes only, nothing
allocated), and the unported families refused when a model is built."""
import dataclasses

import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro_torch.models import LM

ARCHS = jconfigs.list_archs()
PORTED = ["qwen2.5-3b", "stablelm-1.6b", "stablelm-3b", "nemotron-4-340b",
          "phi-3-vision-4.2b", "whisper-base"]
UNPORTED = {"mixtral-8x7b": "MoE", "deepseek-v2-lite-16b": "MLA",
            "mamba2-2.7b": "Mamba-2", "jamba-v0.1-52b": "Mamba-2"}


def test_registry_matches_reference():
    assert tconfigs.list_archs() == ARCHS and len(ARCHS) == 10
    assert sorted(PORTED + list(UNPORTED)) == ARCHS
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


def test_qwen_param_count():
    cfg = tconfigs.get_config("qwen2.5-3b")
    assert cfg.param_count() == 3_086_200_832
    assert cfg.padded_vocab == 152_064


@pytest.mark.parametrize("arch", list(UNPORTED))
def test_unported_family_raises(arch):
    cfg = tconfigs.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match=UNPORTED[arch]) as err:
        LM(cfg, device="cpu")
    assert "ROADMAP queue 1 item 11" in str(err.value)
    with pytest.raises(NotImplementedError):
        cfg.param_count()
