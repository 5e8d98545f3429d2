"""PyTorch port, MLA attention and the sort-based MoE on the CPU: the layers
against the JAX package's ``mla_attention`` and ``moe`` on the same
parameters and inputs, and the two families that need them
(deepseek-v2-lite-16b, mixtral-8x7b) end to end at their reduced sizes
against the JAX package's models (the reference's ``init_params`` through
``repro_torch.convert``).

Bars, as in ``tests/test_torch_models.py``: float32 logits of
``forward_train``, prefill and every teacher-forced decode step within
1e-4 with equal greedy tokens; bfloat16 within 1e-2.  ``forward_train``'s
aux loss within 1e-6 in float32; in bfloat16 within 1e-4 of its size
(at least 1), since the float32 router reads hidden states that differ
by bfloat16 rounding (the readings here are 3e-5 to 4e-5 of it).  Routing is compared where it is robust:
each MoE case asserts the smallest gap between a token's K-th and
(K+1)-th router probability, so a float32 rounding cannot flip an expert.
The reduced configs are dropless (``capacity_factor = E / K``); the
"drop" cases lower the capacity until assignments overflow and hold the
dropping rule, and the drop count against one computed here from the
reference's routing.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models as jmodels
import repro.models.layers as jlayers
from repro.configs import get_config as jax_get_config
from repro.serving import ServeEngine as JServeEngine
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
AUX_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
B, S, P = 2, 20, 8

# case -> (arch, config overrides); P prompt tokens, the other S - P decoded
CASES = {
    "deepseek": ("deepseek-v2-lite-16b", {}),
    # 8 layers: a first_dense group, then a scan-stacked group in the
    # reference's parameter layout
    "deepseek-scan8": ("deepseek-v2-lite-16b", {"num_layers": 8}),
    "mixtral": ("mixtral-8x7b", {}),
    # capacity below the load: assignments dropped in forward_train and
    # in the prefill (the decode steps' 2 tokens never overflow 8 slots)
    "deepseek-drop": ("deepseek-v2-lite-16b", {"capacity_factor": 0.25,
                                               "moe_groups": 0}),
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
    full, aux = train(params, tokens)
    return dict(arrays=_to_numpy(params), tokens=tokens, full=np.asarray(full),
                aux=float(aux), steps=np.stack(steps, 1),
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


def _dropped(model) -> int:
    return sum(int(layer.ffn.dropped) for layer in model.layers if layer.moe)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference(reference, case, dtype):
    ref = reference(case, dtype)
    cfg = _cfg(get_config, case, dtype)
    model = lm_params_from_arrays(cfg, ref["arrays"], device="cpu")
    tol = TOL[dtype]

    full, aux = forward_train(model, ref["tokens"], cfg)
    assert full.dtype == torch.float32 and full.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(full.numpy(), ref["full"], rtol=0, atol=tol)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - ref["aux"]) < AUX_TOL[dtype] * max(1.0, abs(ref["aux"]))
    assert float(aux) > 0
    train_dropped = _dropped(model)

    logits, cache = forward_prefill(model, ref["tokens"][:, :P], cfg, max_len=S)
    prefill_dropped = _dropped(model)
    steps = [logits]
    for t in range(P, S):
        logits, cache = forward_decode(model, ref["tokens"][:, t:t + 1], cache, cfg)
        steps.append(logits)
    steps = torch.stack(steps, 1)
    np.testing.assert_allclose(steps.numpy(), ref["steps"], rtol=0, atol=tol)
    if case.endswith("-drop"):
        assert train_dropped > 0 and prefill_dropped > 0
    else:
        assert train_dropped == prefill_dropped == 0
    if dtype == "float32":
        np.testing.assert_array_equal(steps.argmax(-1).numpy(),
                                      ref["steps"].argmax(-1))
        if not case.endswith("-drop"):
            # dropless: the cache reproduces the full-sequence pass
            np.testing.assert_allclose(steps.numpy(), full[:, P - 1:].numpy(),
                                       rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["deepseek", "deepseek-scan8", "mixtral"])
def test_greedy_tokens_match_reference(reference, case):
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case)
    engine = ServeEngine(cfg, ref["arrays"], device="cpu")
    out = engine.generate_batch(ref["tokens"][:, :P], S - P)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref["greedy"])


def test_serve_engine_matches_reference_engine(reference):
    """``generate_batch`` against the reference's ``ServeEngine`` on the
    same parameters and prompts (three prompt shapes)."""
    ref = reference("deepseek", "float32")
    cfg = _cfg(get_config, "deepseek")
    jparams = jax.tree.map(jnp.asarray, ref["arrays"])
    jengine = JServeEngine(ref["cfg"], jparams)
    engine = ServeEngine(cfg, ref["arrays"], device="cpu")
    rng = np.random.default_rng(7)
    for shape, new in (((3, 12), 6), ((1, 7), 9), ((4, 16), 4)):
        prompts = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        np.testing.assert_array_equal(engine.generate_batch(prompts, new),
                                      jengine.generate_batch(prompts, new))


@pytest.mark.parametrize("case", ["deepseek-scan8", "mixtral"])
def test_port_init_runs_in_reference(reference, case):
    """The port's own init in the reference's layout (scan groups
    stacked): the reference's forward on it equals the port's."""
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case)
    model = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    arrays = lm_params_to_arrays(model)
    assert jax.tree.structure(arrays) == jax.tree.structure(ref["arrays"])
    want, want_aux = ref["train"](arrays, ref["tokens"])
    got, aux = forward_train(model, ref["tokens"], cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["float32"])
    assert abs(float(aux) - float(want_aux)) < AUX_TOL["float32"]


@pytest.mark.parametrize("case", ["deepseek", "deepseek-scan8", "mixtral"])
def test_reference_layout_round_trip(reference, case):
    ref = reference(case, "float32")
    cfg = _cfg(get_config, case)
    model = lm_params_from_arrays(cfg, ref["arrays"], device="cpu")
    names = dict(model.named_parameters())
    assert {"layers.1.ffn.router", "layers.1.ffn.experts.w_gate"} <= names.keys()
    if case.startswith("deepseek"):
        assert {"layers.1.attn.w_dkv", "layers.1.ffn.shared.w_up",
                "layers.0.ffn.w_up"} <= names.keys()
        assert names["layers.1.attn.kv_norm.scale"].dtype == torch.float32
    back = lm_params_to_arrays(model)
    assert jax.tree.structure(back) == jax.tree.structure(ref["arrays"])
    jax.tree.map(np.testing.assert_array_equal, back, ref["arrays"])


def test_scan8_layout_is_first_dense_then_stacked(reference):
    """deepseek at 8 layers: the reference's first_dense group (layer 0,
    a dense MLP), then one scan group stacking layers 1-7 (MoE)."""
    ref = reference("deepseek-scan8", "float32")
    blocks = ref["arrays"]["blocks"]
    assert len(blocks) == 2 and "layers" in blocks[0] and "pattern" in blocks[1]
    assert blocks[0]["layers"][0]["ffn"]["w_up"].ndim == 2
    assert blocks[1]["pattern"][0]["ffn"]["experts"]["w_gate"].shape[0] == 7


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["deepseek", "deepseek-scan8", "mixtral"])
def test_param_specs_are_the_modules(case, dtype):
    cfg = _cfg(get_config, case, dtype)
    model = LM(cfg, device="cpu")
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()}
    specs = param_specs(cfg)
    assert list(got) == list(specs)
    assert got == {n: (tuple(s), dt) for n, (s, dt) in specs.items()}
    assert cfg.param_count() == sum(p.numel() for p in model.parameters())
    ref = _cfg(jax_get_config, case, dtype)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    for name, (_, dt) in specs.items():
        if name.endswith(("router", "scale")):
            assert dt == "float32", name


@pytest.mark.parametrize("case", ["deepseek", "mixtral"])
def test_cache_layout(case):
    cfg = _cfg(get_config, case)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, cache = forward_prefill(model, np.zeros((B, P), np.int32), cfg, max_len=S)
    # mixtral's SWA cache is the rolling buffer of ``window`` (32) slots
    spec = cache_specs(cfg, B, cfg.window or S)
    assert cache["pos"] == P and cache["enc_kv"] is None
    assert len(cache["layers"]) == len(spec["layers"]) == cfg.num_layers
    for c, s in zip(cache["layers"], spec["layers"]):
        assert {k: tuple(v.shape) for k, v in c.items()} == \
            {k: shape for k, (shape, _) in s.items()}
    if cfg.attention == "mla":
        assert set(cache["layers"][0]) == {"ckv", "krope"}
        assert cache["layers"][0]["ckv"].shape == (B, S, cfg.kv_lora_rank)
        assert cache["layers"][0]["krope"].shape == (B, S, cfg.qk_rope_head_dim)
    else:
        assert set(cache["layers"][0]) == {"k", "v"}
        assert cache["layers"][0]["k"].shape[1] == cfg.window == 32


def test_decode_past_the_mla_cache_raises():
    cfg = _cfg(get_config, "deepseek")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, cache = forward_prefill(model, np.zeros((1, 4), np.int32), cfg, max_len=5)
    _, cache = forward_decode(model, np.zeros((1, 1), np.int32), cache, cfg)
    with pytest.raises(IndexError, match="holds 5 positions"):
        forward_decode(model, np.zeros((1, 1), np.int32), cache, cfg)


# -- the layers against the reference's functions ------------------------------

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


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


@pytest.fixture(scope="module")
def mla_case():
    """deepseek's reduced MLA with random weights, a causal pass over
    ``S`` tokens and the reference's outputs: the causal output and its
    cache, then ``S - P`` decode steps after a causal pass over ``P``."""
    cfg = _cfg(get_config, "deepseek")
    jcfg = _cfg(jax_get_config, "deepseek")
    rng = np.random.default_rng(11)
    mla = tlayers.MLAttention(cfg, "cpu")
    p = _fill(mla, rng)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    want, wcache = jlayers.mla_attention(p, jnp.asarray(x), jcfg,
                                         positions=jnp.asarray(pos), mode="causal")
    _, c = jlayers.mla_attention(p, jnp.asarray(x[:, :P]), jcfg,
                                 positions=jnp.asarray(pos[:, :P]), mode="causal")
    pad = ((0, 0), (0, S - P), (0, 0))
    c = {"ckv": jnp.pad(c["ckv"], pad), "krope": jnp.pad(c["krope"], pad),
         "index": c["index"]}
    steps = []
    for t in range(P, S):
        o, c = jlayers.mla_attention(p, jnp.asarray(x[:, t:t + 1]), jcfg,
                                     positions=jnp.asarray(pos[:, t:t + 1]),
                                     mode="decode", cache=c)
        steps.append(np.asarray(o))
    return dict(cfg=cfg, mla=mla, x=x, pos=pos, want=np.asarray(want),
                wcache={k: np.asarray(wcache[k]) for k in ("ckv", "krope")},
                steps=np.concatenate(steps, 1), dcache=c)


def _mla_rope(cfg, pos):
    return tlayers.rotary_cos_sin(torch.from_numpy(np.ascontiguousarray(pos)),
                                  cfg.rope_theta, cfg.qk_rope_head_dim,
                                  torch.float32)


def test_mla_causal_matches_reference(mla_case):
    cfg, mla, x = mla_case["cfg"], mla_case["mla"], mla_case["x"]
    cache = {"ckv": torch.zeros(B, S, cfg.kv_lora_rank),
             "krope": torch.zeros(B, S, cfg.qk_rope_head_dim)}
    with torch.no_grad():
        got = mla(torch.from_numpy(x), _mla_rope(cfg, mla_case["pos"]),
                  tlayers.causal_mask(S, 0, "cpu"), mode="causal", cache=cache)
    _close(got, mla_case["want"], 1e-5)
    for k in ("ckv", "krope"):
        _close(cache[k], mla_case["wcache"][k], 1e-5)


def test_mla_decode_matches_reference(mla_case):
    """A causal pass over P tokens into an S-slot cache, then one decode
    step a token, each step's output and the final cache against the
    reference's."""
    cfg, mla, x, pos = mla_case["cfg"], mla_case["mla"], mla_case["x"], mla_case["pos"]
    cache = {"ckv": torch.zeros(B, S, cfg.kv_lora_rank),
             "krope": torch.zeros(B, S, cfg.qk_rope_head_dim)}
    steps = []
    with torch.no_grad():
        mla(torch.from_numpy(x[:, :P]), _mla_rope(cfg, pos[:, :P]),
            tlayers.causal_mask(P, 0, "cpu"), mode="causal", cache=cache)
        for t in range(P, S):
            steps.append(mla(torch.from_numpy(x[:, t:t + 1]),
                             _mla_rope(cfg, pos[:, t:t + 1]),
                             tlayers.decode_mask(S, t, 0, "cpu"),
                             mode="decode", cache=cache, index=t))
    _close(torch.cat(steps, 1), mla_case["steps"], 1e-5)
    for k in ("ckv", "krope"):
        _close(cache[k], mla_case["dcache"][k], 1e-5)
    # the decode steps reproduce the causal pass over all S tokens
    _close(torch.cat(steps, 1), mla_case["want"][:, P:], 1e-5)


def test_mla_rotates_its_rope_width():
    """MLA's rotary runs over qk_rope_head_dim (frequencies over its half),
    not over the model's head width: at full size 64 against 128."""
    cfg = get_config("deepseek-v2-lite-16b")
    assert (cfg.qk_rope_head_dim, cfg.hd) == (64, 128)
    from repro_torch.models.model import _rope
    cos, _ = _rope(cfg, torch.arange(3)[None], torch.float32)
    assert cos.shape == (1, 3, 1, 32)
    want = jlayers.apply_rotary(jnp.ones((1, 3, 1, 64)), jnp.arange(3)[None],
                                cfg.rope_theta)
    got = tlayers.rotate(torch.ones(1, 3, 1, 64), *_rope(cfg, torch.arange(3)[None],
                                                         torch.float32))
    _close(got, want, 1e-6)


# MoE cases: (arch, config overrides, B, S); the drop case lowers the
# capacity until experts overflow
MOE_CASES = {
    "deepseek-groups": ("deepseek-v2-lite-16b", {}, 2, 16),       # G = 16
    "deepseek-one-group": ("deepseek-v2-lite-16b", {}, 2, 5),     # 10 % 16: G = 1
    "mixtral-groups": ("mixtral-8x7b", {"moe_groups": 4}, 2, 32),  # G = 4
    "deepseek-drop": ("deepseek-v2-lite-16b",
                      {"capacity_factor": 0.25, "moe_groups": 2}, 2, 32),
    "mixtral-drop": ("mixtral-8x7b", {"capacity_factor": 0.5, "moe_groups": 0}, 2, 32),
}


def _moe_setup(case, dtype="float32"):
    arch, overrides, b, s = MOE_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **overrides)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype, **overrides)
    rng = np.random.default_rng(13)
    moe = tlayers.MoE(cfg, "cpu")
    p = _fill(moe, rng, scale=0.2)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, moe, p, x


def _reference_drops(cfg, p, x):
    """Assignments past capacity, from the reference's routing: per group
    and expert, max(0, assignments - cap); and the smallest gap between a
    token's K-th and (K+1)-th router probability."""
    N, D = x.shape[0] * x.shape[1], x.shape[2]
    G, cap = tlayers.moe_capacity(cfg, N)
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x.reshape(N, D)) @ p["router"], axis=-1))
    top = np.sort(probs, -1)[:, ::-1]
    gap = float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min())
    top_i = np.asarray(jax.lax.top_k(jnp.asarray(probs), cfg.top_k)[1])
    drops = 0
    for g in top_i.reshape(G, -1):
        counts = np.bincount(g, minlength=cfg.n_experts)
        drops += int(np.maximum(counts - cap, 0).sum())
    return drops, gap, G, cap


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    cfg, jcfg, moe, p, x = _moe_setup(case)
    want, want_aux = jlayers.moe(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = moe(torch.from_numpy(x))
    _close(got, want, 1e-5)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) < 1e-6
    drops, gap, G, cap = _reference_drops(cfg, p, x)
    assert gap > 1e-4, gap           # no near-tie: routing is the reference's
    assert int(moe.dropped) == drops
    if case.endswith("-drop"):
        assert drops > 0
    else:
        assert drops == 0
    if case.endswith("groups"):
        assert G > 1
    if case == "deepseek-one-group":
        assert G == 1 and cap == 16


@pytest.mark.parametrize("case", ["deepseek-groups", "mixtral-drop"])
def test_moe_bf16_matches_reference(case):
    cfg, jcfg, moe, p, x = _moe_setup(case, "bfloat16")
    jp = {k: v if k == "router" else jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
          for k, v in p.items()}
    xb = torch.from_numpy(x).bfloat16()
    want, want_aux = jlayers.moe(jp, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                 jcfg)
    with torch.no_grad():
        got, aux = moe(xb)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close(got, want, 3e-2 * float(np.abs(np.asarray(want, np.float32)).max()))
    assert abs(float(aux) - float(want_aux)) < 1e-4


def test_moe_one_group_combine_is_fixed_order():
    """The combine sums each token's K contributions in assignment order:
    the same inputs give the same bits, and each output row is the sum of
    its K gated expert rows."""
    cfg, _, moe, _, x = _moe_setup("mixtral-drop")
    e = moe.experts
    xg = torch.from_numpy(x).reshape(1, -1, cfg.d_model)
    with torch.no_grad():
        a = tlayers.moe_one_group(xg, moe.router, e.w_gate, e.w_up, e.w_down,
                                  cfg.act, cfg.top_k, 16)
        b = tlayers.moe_one_group(xg, moe.router, e.w_gate, e.w_up, e.w_down,
                                  cfg.act, cfg.top_k, 16)
        assert torch.equal(a[0], b[0])
        # dropless capacity: every row is its K experts' gated outputs
        out, _, dropped = tlayers.moe_one_group(
            xg, moe.router, e.w_gate, e.w_up, e.w_down, cfg.act, cfg.top_k,
            xg.shape[1])
        assert int(dropped.sum()) == 0
        probs = torch.softmax(xg[0] @ moe.router, -1)
        top_p, top_i = probs.topk(cfg.top_k, -1)
        gates = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
        want = torch.zeros_like(xg[0])
        for k in range(cfg.top_k):
            w = e.w_gate[top_i[:, k]], e.w_up[top_i[:, k]], e.w_down[top_i[:, k]]
            h = torch.nn.functional.silu(torch.einsum("nd,ndf->nf", xg[0], w[0])) \
                * torch.einsum("nd,ndf->nf", xg[0], w[1])
            want += gates[:, k:k + 1] * torch.einsum("nf,nfd->nd", h, w[2])
        torch.testing.assert_close(out[0], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [8, 10, 64, 512, 528])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_moe_capacity_rule(arch, n):
    """Groups and capacity at full size against the reference's formula
    (``models/layers.py``: G = moe_groups when it divides N, cap =
    max(8, ceil(N/G*K/E*cf)) rounded up to 8)."""
    cfg = get_config(arch)
    G, cap = tlayers.moe_capacity(cfg, n)
    want_g = cfg.moe_groups if n % cfg.moe_groups == 0 else 1
    want_cap = int(math.ceil(n // want_g * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor))
    assert (G, cap) == (want_g, max(8, ((want_cap + 7) // 8) * 8))
    if arch.startswith("deepseek") and n == 512:
        assert (G, cap) == (16, 8)     # the served prefill: B = 4, prompt 128
