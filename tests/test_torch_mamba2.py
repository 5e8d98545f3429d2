"""PyTorch port, the Mamba-2 (SSD) block and its state cache on the CPU:
``ssd_chunked`` against the JAX package's ``_ssd_chunked`` and against a
plain per-step recurrence in float64, the ``Mamba2`` block against
``mamba2_block`` (causal and decode), and the two families that need it
(mamba2-2.7b, jamba-v0.1-52b) end to end at their reduced sizes against
the JAX package's models (the reference's ``init_params`` through
``repro_torch.convert``).

Bars: the scan 1e-5 against the reference and 1e-10 against the
recurrence; the block and its decode step 1e-5; float32 logits of
``forward_train``, prefill and every teacher-forced decode step within
1e-4 with equal greedy tokens.  bfloat16: mamba2's logits within 1e-2.
jamba's bfloat16 logits within 3e-2: the reference's jitted and op-by-op
bfloat16 runs of the 8-layer jamba already differ by 1.46e-2, more than
1e-2, so no port can be held to 1e-2 of either.  A bfloat16 run must also
differ from the port's own float32 run on the same (bfloat16-valued)
parameters by at least half the reference's bfloat16-to-float32 gap, so a
run that computes in float32 does not pass.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models as jmodels
import repro.models.layers as jlayers
import repro.models.model as jmodel
from repro.configs import get_config as jax_get_config
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
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
# reduced jamba in bfloat16 on these inputs: the port 1.46e-2 from the
# reference, the reference's own bfloat16-to-float32 gap 1.44e-2 and the
# port's 9.2e-3 (mamba2: 6.2e-3, 6.2e-3 and 4.4e-3), the reference's jitted
# and op-by-op runs 1.46e-2 apart
JAMBA_BF16_TOL = 3e-2
B, S, P = 2, 20, 8

# case -> (arch, config overrides); P prompt tokens, the other S - P decoded
CASES = {
    "mamba2": ("mamba2-2.7b", {}),                       # 2 layers, no attention
    "jamba": ("jamba-v0.1-52b", {}),                     # 8 layers: one period
    # the reference's scan-stacked layouts: period 1 x 8, period 8 x 2
    "mamba2-scan8": ("mamba2-2.7b", {"num_layers": 8}),
    "jamba-scan16": ("jamba-v0.1-52b", {"num_layers": 16}),
}
DTYPES = ["float32", "bfloat16"]


def _cfg(registry, case, dtype="float32"):
    arch, overrides = CASES[case]
    return dataclasses.replace(registry(arch).reduced(), dtype=dtype, **overrides)


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _reference_run(case, dtype):
    cfg = _cfg(jax_get_config, case, dtype)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    train = jax.jit(lambda p, t: jmodels.forward_train(p, t, cfg))
    prefill = jax.jit(lambda p, t: jmodels.forward_prefill(p, t, cfg, max_len=S))
    decode = jax.jit(lambda p, t, c: jmodels.forward_decode(p, t, c, cfg))

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
    full, _ = train(params, tokens)
    arrays = _to_numpy(params)
    run = dict(arrays=arrays, tokens=tokens, full=np.asarray(full),
               steps=np.stack(steps, 1), greedy=np.stack(greedy, 1),
               train=train, cfg=cfg)
    if dtype == "bfloat16":
        # the reference's own float32 logits on the same bfloat16 values
        f32 = dataclasses.replace(cfg, dtype="float32")
        want, _ = jax.jit(lambda p, t: jmodels.forward_train(p, t, f32))(
            jax.tree.map(jnp.asarray, arrays), tokens)
        run["gap"] = float(np.abs(np.asarray(want) - run["full"]).max())
    return run


@pytest.fixture(scope="module")
def reference():
    """(case, dtype) -> the reference's run, each built once."""
    runs = {}

    def get(case, dtype):
        if (case, dtype) not in runs:
            runs[case, dtype] = _reference_run(case, dtype)
        return runs[case, dtype]

    return get


def _bar(case, dtype):
    if dtype == "bfloat16" and case.startswith("jamba"):
        return JAMBA_BF16_TOL
    return TOL[dtype]


# -- the SSD scan --------------------------------------------------------------

def _ssd_inputs(rng, dtype=np.float32, Bb=2, L=64, H=3, Pd=4, N=5):
    """Inputs at the block's scale: x, B and C as silu outputs of unit
    pre-activations, dt a softplus, A in -exp([-1, 1])."""
    silu = lambda v: v / (1 + np.exp(-v))  # noqa: E731
    xh = silu(rng.normal(size=(Bb, L, H, Pd))).astype(dtype)
    dt = np.log1p(np.exp(rng.normal(size=(Bb, L, H)))).astype(dtype)
    A = -np.exp(rng.uniform(-1, 1, size=H)).astype(dtype)
    Bs = silu(rng.normal(size=(Bb, L, N))).astype(dtype)
    Cs = silu(rng.normal(size=(Bb, L, N))).astype(dtype)
    h0 = rng.normal(size=(Bb, H, Pd, N)).astype(dtype)
    return xh, dt, A, Bs, Cs, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_ssd_chunked_matches_reference(with_h0):
    """Chunk 16 over 64 positions (4 chunks, so the recurrence runs)."""
    xh, dt, A, Bs, Cs, h0 = _ssd_inputs(np.random.default_rng(3))
    h0 = h0 if with_h0 else None
    want_y, want_h = jlayers._ssd_chunked(
        *map(jnp.asarray, (xh, dt, A, Bs, Cs)), 16,
        None if h0 is None else jnp.asarray(h0))
    got_y, got_h = tlayers.ssd_chunked(
        *map(torch.from_numpy, (xh, dt, A, Bs, Cs)), 16,
        None if h0 is None else torch.from_numpy(h0))
    assert got_y.dtype == got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_ssd_chunked_is_the_recurrence(with_h0, chunk):
    """In float64 the chunked form is the per-step recurrence
    ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = C_t h_t``."""
    xh, dt, A, Bs, Cs, h0 = _ssd_inputs(np.random.default_rng(4), np.float64)
    h = h0.copy() if with_h0 else np.zeros_like(h0)
    ys = []
    for t in range(xh.shape[1]):
        h = (np.exp(dt[:, t] * A)[:, :, None, None] * h
             + dt[:, t][:, :, None, None] * xh[:, t][..., None] * Bs[:, t][:, None, None, :])
        ys.append(np.einsum("bn,bhpn->bhp", Cs[:, t], h))
    got_y, got_h = tlayers.ssd_chunked(
        *map(torch.from_numpy, (xh, dt, A, Bs, Cs)), chunk,
        torch.from_numpy(h0) if with_h0 else None)
    assert got_y.dtype == torch.float64
    np.testing.assert_allclose(got_y.numpy(), np.stack(ys, 1), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_h.numpy(), h, rtol=0, atol=1e-10)


def test_ssd_refuses_partial_chunks():
    """Past one chunk, a length must be whole chunks: 200 positions at
    chunk 128 fail in both packages; 64 (one short chunk) and 256 run."""
    cfg = _cfg(get_config, "mamba2")
    jcfg = _cfg(jax_get_config, "mamba2")
    block = tlayers.Mamba2(cfg, "cpu")
    p = _fill(block, np.random.default_rng(0))
    x = np.zeros((1, 200, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jlayers.mamba2_block(p, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="whole chunks of 128"):
        with torch.no_grad():
            block(torch.from_numpy(x))
    xh, dt, A, Bs, Cs, _ = map(torch.from_numpy, _ssd_inputs(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="whole chunks of 48"):
        tlayers.ssd_chunked(xh, dt, A, Bs, Cs, 48)
    assert tlayers.ssd_chunked(xh, dt, A, Bs, Cs, 128)[0].shape == xh.shape


# -- the block against the reference's ------------------------------------------

def _fill(module, rng, scale=0.1):
    """Random weights for a module's parameters; the reference's tree of
    the same leaves (nested at the dots of the names)."""
    tree = {}
    with torch.no_grad():
        for name, w in module.named_parameters():
            a = (rng.normal(size=w.shape) * scale).astype(np.float32)
            if name.endswith("scale"):
                a = 1.0 + a
            w.copy_(torch.from_numpy(a))
            node, keys = tree, name.split(".")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = jnp.asarray(a)
    return tree


def _zero_cache(cfg, b):
    return {name: torch.zeros(shape, dtype=tlayers.torch_dtype(dt))
            for name, (shape, dt) in cache_specs(cfg, b, 1)["layers"][0].items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


@pytest.fixture(scope="module")
def block_case():
    cfg = _cfg(get_config, "mamba2")
    jcfg = _cfg(jax_get_config, "mamba2")
    block = tlayers.Mamba2(cfg, "cpu")
    p = _fill(block, np.random.default_rng(11))
    x = np.random.default_rng(12).normal(size=(B, 257, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, block, p, x


@pytest.mark.parametrize("length", [2, 33, 256])
def test_mamba2_causal_matches_reference(block_case, length):
    """2 positions (the conv history padded on the left), 33 (one chunk),
    256 (two chunks of 128): output, state and conv history."""
    cfg, jcfg, block, p, x = block_case
    want, wcache = jlayers.mamba2_block(p, jnp.asarray(x[:, :length]), jcfg)
    cache = _zero_cache(cfg, B)
    with torch.no_grad():
        got = block(torch.from_numpy(x[:, :length]), cache=cache)
        alone = block(torch.from_numpy(x[:, :length]))
    _close(got, want, 1e-5)
    assert torch.equal(got, alone)
    assert cache["h"].dtype == torch.float32
    _close(cache["h"], wcache["h"], 1e-5)
    _close(cache["conv"], wcache["conv"], 1e-5)
    if length == 2:
        assert not cache["conv"][:, 0].any() and cache["conv"][:, 1:].abs().sum() > 0


@pytest.mark.parametrize("length", [2, 33])
def test_mamba2_decode_matches_reference(block_case, length):
    """A causal pass over ``length`` positions, then one decode step:
    output, state and conv history against the reference's, and the step
    against the causal pass over ``length + 1``."""
    cfg, jcfg, block, p, x = block_case
    _, wcache = jlayers.mamba2_block(p, jnp.asarray(x[:, :length]), jcfg)
    want, wcache = jlayers.mamba2_block(p, jnp.asarray(x[:, length:length + 1]),
                                        jcfg, mode="decode", cache=wcache)
    cache = _zero_cache(cfg, B)
    with torch.no_grad():
        block(torch.from_numpy(x[:, :length]), cache=cache)
        h, conv = cache["h"], cache["conv"]
        got = block(torch.from_numpy(x[:, length:length + 1]), mode="decode",
                    cache=cache)
        full = block(torch.from_numpy(x[:, :length + 1]))
    assert cache["h"] is h and cache["conv"] is conv     # written in place
    _close(got, want, 1e-5)
    _close(cache["h"], wcache["h"], 1e-5)
    _close(cache["conv"], wcache["conv"], 1e-5)
    _close(got, full[:, -1:].numpy(), 1e-5)


# -- the models end to end --------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["mamba2", "jamba"])
def test_logits_match_reference(reference, case, dtype):
    ref = reference(case, dtype)
    cfg = _cfg(get_config, case, dtype)
    model = lm_params_from_arrays(cfg, ref["arrays"], device="cpu")
    tol = _bar(case, dtype)

    full, _ = forward_train(model, ref["tokens"], cfg)
    assert full.dtype == torch.float32 and full.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(full.numpy(), ref["full"], rtol=0, atol=tol)
    if dtype == "bfloat16":   # not a float32 run in disguise
        f32 = dataclasses.replace(cfg, dtype="float32")
        want, _ = forward_train(lm_params_from_arrays(f32, ref["arrays"], device="cpu"),
                                ref["tokens"], f32)
        own_gap = (full - want).abs().max().item()
        assert own_gap >= ref["gap"] / 2, (own_gap, ref["gap"])
    logits, cache = forward_prefill(model, ref["tokens"][:, :P], cfg, max_len=S)
    steps = [logits]
    for t in range(P, S):
        logits, cache = forward_decode(model, ref["tokens"][:, t:t + 1], cache, cfg)
        steps.append(logits)
    steps = torch.stack(steps, 1)
    np.testing.assert_allclose(steps.numpy(), ref["steps"], rtol=0, atol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(steps.argmax(-1).numpy(),
                                      ref["steps"].argmax(-1))


@pytest.mark.parametrize("case", ["mamba2", "jamba", "mamba2-scan8"])
def test_prefill_decode_match_train(reference, case):
    """The reference's own check (``tests/test_models.py``): B = 2, 33
    tokens, a prefill over 32 and one decode step against
    ``forward_train``'s last two positions, here to 1e-4; and every step
    of a prefill over 8 and 25 decode steps."""
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case)
    model = lm_params_from_arrays(cfg, ref["arrays"], device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 33)).astype(np.int32)
    full, _ = forward_train(model, tokens, cfg)
    lp, cache = forward_prefill(model, tokens[:, :-1], cfg, max_len=37)
    ld, cache = forward_decode(model, tokens[:, -1:], cache, cfg)
    _close(lp, full[:, -2].numpy(), TOL["float32"])
    _close(ld, full[:, -1].numpy(), TOL["float32"])
    logits, cache = forward_prefill(model, tokens[:, :8], cfg, max_len=33)
    steps = [logits]
    for t in range(8, 33):
        logits, cache = forward_decode(model, tokens[:, t:t + 1], cache, cfg)
        steps.append(logits)
    _close(torch.stack(steps, 1), full[:, 7:].numpy(), TOL["float32"])


@pytest.mark.parametrize("case", ["mamba2", "jamba", "mamba2-scan8"])
def test_greedy_tokens_match_reference(reference, case):
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case)
    out = ServeEngine(cfg, ref["arrays"], device="cpu").generate_batch(
        ref["tokens"][:, :P], S - P)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref["greedy"])


@pytest.mark.parametrize("case", ["mamba2", "jamba"])
def test_serve_engine_matches_reference_engine(reference, case):
    """``generate_batch`` against the reference's ``ServeEngine`` on the
    same parameters and prompts (three prompt shapes)."""
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case)
    jengine = JServeEngine(ref["cfg"], jax.tree.map(jnp.asarray, ref["arrays"]))
    engine = ServeEngine(cfg, ref["arrays"], device="cpu")
    rng = np.random.default_rng(7)
    for shape, new in (((3, 12), 6), ((1, 7), 9), ((4, 16), 4)):
        prompts = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        np.testing.assert_array_equal(engine.generate_batch(prompts, new),
                                      jengine.generate_batch(prompts, new))


@pytest.mark.parametrize("case", ["mamba2-scan8", "jamba"])
def test_port_init_runs_in_reference(reference, case):
    """The port's own init in the reference's layout: the reference's
    forward on it equals the port's."""
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case)
    model = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    arrays = lm_params_to_arrays(model)
    assert jax.tree.structure(arrays) == jax.tree.structure(ref["arrays"])
    want, _ = ref["train"](arrays, ref["tokens"])
    got, _ = forward_train(model, ref["tokens"], cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["float32"])


@pytest.mark.parametrize("case", list(CASES))
def test_reference_layout_round_trip(reference, case):
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case)
    model = lm_params_from_arrays(cfg, ref["arrays"], device="cpu")
    names = dict(model.named_parameters())
    for leaf in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                 "out_norm.scale", "out_proj"):
        assert f"layers.0.mamba.{leaf}" in names
    for leaf in ("A_log", "D", "dt_bias", "out_norm.scale"):
        assert names[f"layers.0.mamba.{leaf}"].dtype == torch.float32
    back = lm_params_to_arrays(model)
    assert jax.tree.structure(back) == jax.tree.structure(ref["arrays"])
    jax.tree.map(np.testing.assert_array_equal, back, ref["arrays"])


@pytest.mark.parametrize("arch,layers,groups", [
    ("mamba2-2.7b", None, [(0, 1, 64)]),
    ("mamba2-2.7b", 8, [(0, 1, 8)]),
    ("jamba-v0.1-52b", None, [(0, 8, 4)]),
    ("jamba-v0.1-52b", 16, [(0, 8, 2)]),
    ("jamba-v0.1-52b", 8, [(0, None, None)]),
])
def test_layer_groups_match_reference(arch, layers, groups):
    """The scan groups ``convert`` reads at full width (nothing
    allocated): mamba2 one group of period 1 (64 repeats at full depth),
    jamba period 8; jamba's one 8-layer period is a plain list."""
    cfg = get_config(arch)
    jcfg = jax_get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    got = convert.layer_groups(cfg)
    assert got == jmodel.layer_groups(jcfg)
    assert [(g["start"], g.get("period"), g.get("repeat")) for g in got] == groups


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["mamba2", "jamba", "mamba2-scan8"])
def test_param_specs_are_the_modules(case, dtype):
    cfg = _cfg(get_config, case, dtype)
    model = LM(cfg, device="cpu")
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()}
    specs = param_specs(cfg)
    assert list(got) == list(specs)
    assert got == {n: (tuple(s), dt) for n, (s, dt) in specs.items()}
    ref = _cfg(jax_get_config, case, dtype)
    assert cfg.param_count() == sum(p.numel() for p in model.parameters()) \
        == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    n_mamba = sum(not cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    assert sum(n.endswith(".mamba.A_log") for n in specs) == n_mamba > 0


@pytest.mark.parametrize("case", ["mamba2", "jamba", "mamba2-scan8"])
def test_cache_specs_match_reference(case):
    """Layer for layer the reference's ``_layer_cache_specs`` (its scan
    groups unstacked; its per-layer ``index`` is the port's one ``pos``),
    ``h`` in float32; and a prefill's cache has those buffers."""
    cfg = _cfg(get_config, case, "bfloat16")
    jcfg = _cfg(jax_get_config, case, "bfloat16")
    spec = cache_specs(cfg, B, S)
    want = [jmodel._layer_cache_specs(jcfg, i, B, S) for i in range(cfg.num_layers)]
    assert len(spec["layers"]) == cfg.num_layers
    for i, (got, w) in enumerate(zip(spec["layers"], want)):
        assert got == {k: (shape, dt) for k, (shape, dt, _) in w.items()
                       if k != "index"}, i
        if not cfg.is_attn_layer(i):
            assert got["h"][1] == "float32" and got["conv"][1] == "bfloat16"
    assert spec["pos"] == ((), "int32") and spec["enc_kv"] is None
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, cache = forward_prefill(model, np.zeros((B, P), np.int32), cfg, max_len=S)
    assert cache["pos"] == P
    for c, s in zip(cache["layers"], spec["layers"]):
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in c.items()} == s


@pytest.mark.parametrize("case", ["mamba2", "jamba"])
def test_init_rule(case):
    """The reference's rule for the Mamba leaves: ``A_log`` log(linspace(1,
    16, H)), ``D`` ones, ``dt_bias`` 0.5, ``conv_b`` zeros, the weights
    drawn; the same leaves from the reference's ``init_params``."""
    cfg = _cfg(get_config, case)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jmodels.init_params(_cfg(jax_get_config, case), jax.random.PRNGKey(0))
    mamba = [i for i in range(cfg.num_layers) if not cfg.is_attn_layer(i)]
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    want = np.log(np.linspace(1.0, 16.0, H))
    ref_leaves = convert._reference_leaves(cfg, _to_numpy(ref))
    for i in mamba:
        m = model.layers[i].mamba
        np.testing.assert_allclose(m.A_log.numpy(), want, rtol=0, atol=1e-6)
        assert torch.equal(m.D, torch.ones(H)) and torch.equal(m.dt_bias, torch.full((H,), 0.5))
        assert not m.conv_b.any() and m.conv_w.std() > 0 and m.in_proj.std() > 0
        for leaf in ("A_log", "D", "dt_bias", "conv_b"):
            np.testing.assert_allclose(getattr(m, leaf).numpy(),
                                       ref_leaves[f"layers.{i}.mamba.{leaf}"],
                                       rtol=0, atol=1e-6)


def test_decode_without_attention_has_no_position_limit():
    """mamba2 has no attention layer: its cache has no slots, so decoding
    runs past the prefill's ``max_len`` (as in the reference)."""
    cfg = _cfg(get_config, "mamba2")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    logits, cache = forward_prefill(model, tokens[:, :4], cfg, max_len=5)
    steps = [logits]
    for t in range(4, 12):
        logits, cache = forward_decode(model, tokens[:, t:t + 1], cache, cfg)
        steps.append(logits)
    assert cache["pos"] == 12
    full, _ = forward_train(model, tokens, cfg)
    _close(torch.stack(steps, 1), full[:, 3:].numpy(), TOL["float32"])


def test_hybrid_decode_reads_the_attention_cache():
    """jamba's layer 0 is a Mamba layer: the slot count comes from its
    attention layer (4), so a full cache raises there."""
    cfg = _cfg(get_config, "jamba")
    assert not cfg.is_attn_layer(0) and cfg.is_attn_layer(4)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, cache = forward_prefill(model, np.zeros((1, 4), np.int32), cfg, max_len=5)
    assert set(cache["layers"][0]) == {"h", "conv"}
    assert cache["layers"][4]["k"].shape[1] == 5
    _, cache = forward_decode(model, np.zeros((1, 1), np.int32), cache, cfg)
    with pytest.raises(IndexError, match="holds 5 positions"):
        forward_decode(model, np.zeros((1, 1), np.int32), cache, cfg)
