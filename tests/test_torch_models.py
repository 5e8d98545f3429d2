"""PyTorch port, the LM models on the CPU: the attention-only families
(dense, vlm, audio) at their reduced sizes against the JAX package's
models on the same parameters (the reference's ``init_params`` through
``repro_torch.convert``), tokens and extras.

float32: ``forward_train``, prefill and every teacher-forced decode step's
logits within 1e-4, and greedy tokens equal (the reduced configs' smallest
top-2 logit gap is about 5e-4).  bfloat16: logits within 1e-2, twice the
gap between the reference's own bfloat16 and float32 logits on these
configs (about 4e-3 to 5e-3, logits up to about 1.3 in size); tokens are
not compared in bfloat16.  Beyond the six archs: qwen at 8 layers, whose
reference parameters are scan-stacked, and qwen under SWA with an 8-slot
window, prefilled below and above the window and decoded past it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models as jmodels
import repro.models.layers as jlayers
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays
from repro_torch.models import (
    LM,
    cache_specs,
    forward_decode,
    forward_prefill,
    forward_train,
    init_params,
    param_specs,
)
from repro_torch.models import layers as tlayers
from repro_torch.serving import ServeEngine

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
B, S = 2, 20

# case -> (arch, config overrides, prompt length P); the other S - P
# tokens are decoded one by one
CASES = {
    "qwen2.5-3b": ("qwen2.5-3b", {}, 8),
    "stablelm-1.6b": ("stablelm-1.6b", {}, 8),
    "stablelm-3b": ("stablelm-3b", {}, 8),
    "nemotron-4-340b": ("nemotron-4-340b", {}, 8),
    "phi-3-vision-4.2b": ("phi-3-vision-4.2b", {}, 8),
    "whisper-base": ("whisper-base", {}, 8),
    "qwen2.5-3b-scan8": ("qwen2.5-3b", {"num_layers": 8}, 8),
    "qwen2.5-3b-swa-short": ("qwen2.5-3b", {"attention": "swa", "window": 8}, 5),
    "qwen2.5-3b-swa-long": ("qwen2.5-3b", {"attention": "swa", "window": 8}, 12),
}
DTYPES = ["float32", "bfloat16"]


def _cfg(registry, case, dtype):
    arch, overrides, _ = CASES[case]
    return dataclasses.replace(registry(arch).reduced(), dtype=dtype, **overrides)


def _extras(cfg, rng):
    if cfg.frontend == "audio_stub":
        return {"frames": rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)
                                     ).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return {"patch_embeds": rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)
                                           ).astype(np.float32)}
    return None


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _reference_run(case, dtype):
    """The reference's params (float32 numpy), inputs, full-sequence
    logits, teacher-forced prefill + decode logits and greedy tokens."""
    cfg = _cfg(jax_get_config, case, dtype)
    P = CASES[case][2]
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extras = _extras(cfg, rng)
    train = jax.jit(lambda p, t: jmodels.forward_train(p, t, cfg, extras)[0])
    prefill = jax.jit(lambda p, t: jmodels.forward_prefill(p, t, cfg, extras,
                                                           max_len=S))
    decode = jax.jit(lambda p, t, c: jmodels.forward_decode(p, t, c, cfg, extras))

    logits, cache = prefill(params, tokens[:, :P])
    steps = [np.asarray(logits)]
    for t in range(P, S):
        logits, cache = decode(params, tokens[:, t:t + 1], cache)
        steps.append(np.asarray(logits))
    logits, cache = prefill(params, tokens[:, :P])
    greedy = []
    for _ in range(S - P):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        greedy.append(np.asarray(tok)[:, 0])
        logits, cache = decode(params, tok, cache)
    return dict(arrays=_to_numpy(params), tokens=tokens, extras=extras,
                full=np.asarray(train(params, tokens)), steps=np.stack(steps, 1),
                greedy=np.stack(greedy, 1), train=train, cfg=cfg)


@pytest.fixture(scope="module")
def reference():
    """(case, dtype) -> the reference's run, each built once."""
    runs = {}

    def get(case, dtype):
        if (case, dtype) not in runs:
            runs[case, dtype] = _reference_run(case, dtype)
        return runs[case, dtype]

    return get


def _port_steps(model, cfg, ref, P):
    logits, cache = forward_prefill(model, ref["tokens"][:, :P], cfg,
                                    ref["extras"], max_len=S)
    steps = [logits]
    for t in range(P, S):
        logits, cache = forward_decode(model, ref["tokens"][:, t:t + 1], cache,
                                       cfg, ref["extras"])
        steps.append(logits)
    return torch.stack(steps, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference(reference, case, dtype):
    ref = reference(case, dtype)
    cfg = _cfg(get_config, case, dtype)
    P = CASES[case][2]
    model = lm_params_from_arrays(cfg, ref["arrays"], device="cpu")
    tol = TOL[dtype]

    full, aux = forward_train(model, ref["tokens"], cfg, ref["extras"])
    assert full.dtype == torch.float32 and full.shape == (B, S, cfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(full.numpy(), ref["full"], rtol=0, atol=tol)

    steps = _port_steps(model, cfg, ref, P)
    assert steps.shape == (B, S - P + 1, cfg.padded_vocab)
    np.testing.assert_allclose(steps.numpy(), ref["steps"], rtol=0, atol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(steps.argmax(-1).numpy(),
                                      ref["steps"].argmax(-1))
        # the cache reproduces the full-sequence pass
        np.testing.assert_allclose(steps.numpy(), full[:, P - 1:].numpy(),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_reference(reference, case):
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case, "float32")
    P = CASES[case][2]
    engine = ServeEngine(cfg, ref["arrays"], ref["extras"], device="cpu")
    out = engine.generate_batch(ref["tokens"][:, :P], S - P)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref["greedy"])


@pytest.mark.parametrize("case", ["qwen2.5-3b-scan8", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_port_init_runs_in_reference(reference, case):
    """The port's own init, carried into the reference's layout
    (``lm_params_to_arrays``, scan groups stacked): the reference's
    forward on it equals the port's."""
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case, "float32")
    model = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    arrays = lm_params_to_arrays(model)
    assert jax.tree.structure(arrays) == jax.tree.structure(ref["arrays"])
    want = np.asarray(ref["train"](arrays, ref["tokens"]))
    got, _ = forward_train(model, ref["tokens"], cfg, ref["extras"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL["float32"])


@pytest.mark.parametrize("case", ["qwen2.5-3b-scan8", "whisper-base"])
def test_reference_layout_round_trip(reference, case):
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case, "float32")
    back = lm_params_to_arrays(lm_params_from_arrays(cfg, ref["arrays"],
                                                     device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref["arrays"])
    jax.tree.map(np.testing.assert_array_equal, back, ref["arrays"])


def test_convert_refuses_a_wrong_tree(reference):
    ref = reference("qwen2.5-3b", "float32")
    cfg = _cfg(get_config, "qwen2.5-3b", "float32")
    tree = dict(ref["arrays"], final_norm={})
    with pytest.raises(KeyError, match="final_norm.scale"):
        lm_params_from_arrays(cfg, tree, device="cpu")
    tree = dict(ref["arrays"], embed=ref["arrays"]["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_arrays(cfg, tree, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_param_specs_are_the_modules(case, dtype):
    cfg = _cfg(get_config, case, dtype)
    model = LM(cfg, device="cpu")
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()}
    specs = param_specs(cfg)
    assert list(got) == list(specs)
    assert got == {n: (tuple(s), dt) for n, (s, dt) in specs.items()}
    assert cfg.param_count() == sum(p.numel() for p in model.parameters())
    assert all(not p.requires_grad for p in model.parameters())


def test_init_rule_and_seed():
    cfg = get_config("stablelm-1.6b").reduced()      # layernorm: scale + bias
    a = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p)), name
        elif p.ndim == 1:
            assert torch.equal(p, torch.zeros_like(p)), name
        else:
            assert not torch.equal(p, r), name
            std = min(0.02, 1.0 / np.sqrt(p.shape[-2]))
            assert abs(float(p.float().std()) / std - 1) < 0.15, name


def test_bf16_weights_float32_norms():
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), dtype="bfloat16")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name, p in model.named_parameters():
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name
    logits, _ = forward_train(model, np.zeros((1, 4), np.int32), cfg)
    assert logits.dtype == torch.float32


@pytest.mark.parametrize("case", ["qwen2.5-3b", "qwen2.5-3b-swa-short",
                                  "whisper-base"])
def test_cache_layout(case):
    cfg = _cfg(get_config, case, "float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    P = CASES[case][2]
    extras = _extras(cfg, np.random.default_rng(0))
    tokens = np.zeros((B, P), np.int32)
    _, cache = forward_prefill(model, tokens, cfg, extras, max_len=S)
    spec = cache_specs(cfg, B, S)
    assert cache["pos"] == P
    assert len(cache["layers"]) == len(spec["layers"]) == cfg.num_layers
    for c, s in zip(cache["layers"], spec["layers"]):
        assert tuple(c["k"].shape) == s["k"][0] and tuple(c["v"].shape) == s["v"][0]
    if cfg.encoder_layers:
        assert [tuple(k.shape) for k, _ in cache["enc_kv"]] == \
            [e[0][0] for e in spec["enc_kv"]]
    else:
        assert cache["enc_kv"] is None and spec["enc_kv"] is None


def test_decode_past_the_cache_raises():
    cfg = get_config("qwen2.5-3b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, cache = forward_prefill(model, np.zeros((1, 4), np.int32), cfg, max_len=5)
    _, cache = forward_decode(model, np.zeros((1, 1), np.int32), cache, cfg)
    with pytest.raises(IndexError, match="holds 5 positions"):
        forward_decode(model, np.zeros((1, 1), np.int32), cache, cfg)


def test_model_refuses_another_config():
    cfg = get_config("qwen2.5-3b").reduced()
    model = LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        forward_train(model, np.zeros((1, 4), np.int32),
                      dataclasses.replace(cfg, num_layers=3))


# -- layers against the reference's functions --------------------------------

def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    p = {"scale": scale, "bias": bias} if kind == "layernorm" else {"scale": scale}
    want = jlayers.apply_norm(p, jnp.asarray(x), kind)
    got = tlayers.apply_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias) if kind == "layernorm" else None,
                             kind)
    _close(got, want)
    # bfloat16 activations with float32 parameters come back bfloat16
    xb = torch.from_numpy(x).bfloat16()
    assert tlayers.apply_norm(xb, torch.from_numpy(scale), None, "rmsnorm").dtype \
        == torch.bfloat16


@pytest.mark.parametrize("rd", [16, 4])
def test_rotary_matches_reference(rd):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(3, 10)[None].repeat(2, 0)
    want = jlayers.apply_rotary(jnp.asarray(x), jnp.asarray(pos), 1e6, rd)
    got = tlayers.rotate(torch.from_numpy(x), *tlayers.rotary_cos_sin(
        torch.from_numpy(pos), 1e6, rd, torch.float32))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kv", [4, 2, 1])
def test_sdpa_gqa_matches_reference(kv):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, kv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, kv, 16)).astype(np.float32)
    mask = rng.random((5, 9)) < 0.7
    mask[:, 0] = True
    want = jlayers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask)[None, None, None], 4 // kv)
    got = tlayers.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(mask), 4 // kv)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_reference(act):
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), act=act)
    rng = np.random.default_rng(5)
    mlp = tlayers.MLP(cfg, "cpu")
    p = {}
    with torch.no_grad():
        for name, w in mlp.named_parameters():
            p[name] = (rng.normal(size=w.shape) * 0.1).astype(np.float32)
            w.copy_(torch.from_numpy(p[name]))
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    _close(mlp(torch.from_numpy(x)), want, 1e-5)
