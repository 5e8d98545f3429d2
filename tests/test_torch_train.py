"""PyTorch port, the training pieces on the CPU against the JAX package:
the schedule and the global norm; AdamW and Adafactor for three steps
from carried-over parameters and state (Adafactor also on qwen at 8
layers, whose leaves are scan-stacked, so a stacked norm scale (8, d) is
factored across its layers and a group's layers share one update clip);
microbatch accumulation; int8 gradient compression and the four
collectives; the token pipeline bit for bit; the preemption guard and the
step watchdog.

The optimizer cases feed both packages the same seeded gradients, so the
update alone is compared: parameters and state within float32 rounding
(1e-6 absolute, 1e-5 relative).  The train-step cases compare whole steps
at the reference's own bars (loss 1e-5; parameters 2e-3, see
``test_torch_train_grads.py``).
"""
import dataclasses
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.distributed.collectives as jcoll
import repro.models as jmodels
import repro.train as jtrain
import repro.train.optimizer as jopt
from repro.configs import get_config as jax_get_config
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.launch.train import extras_fn_for as jax_extras_fn_for
from repro_torch.configs import get_config
from repro_torch.convert import (
    _reference_leaves,
    lm_params_from_arrays,
    lm_params_to_arrays,
    opt_state_from_arrays,
    opt_state_to_arrays,
)
from repro_torch.data import TokenPipeline
from repro_torch.models import LM
from repro_torch.distributed import (
    compressed_psum,
    dequantize_int8,
    fake_quantize_grads,
    quantize_int8,
)
from repro_torch.launch.train import extras_fn_for
from repro_torch.train import (
    OptConfig,
    PreemptionGuard,
    StepWatchdog,
    TrainConfig,
    apply_updates,
    cosine_lr,
    global_norm,
    grads_of,
    init_opt_state,
    make_train_step,
)

UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


# ---------------------------------------------------------------------------
# schedule and norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [OptConfig(warmup=5, total_steps=20),
                                 OptConfig(warmup=0, total_steps=7, lr=1e-2),
                                 OptConfig(warmup=10, total_steps=10,
                                           min_lr_frac=0.0)],
                         ids=["warm5", "warm0", "no-decay"])
def test_cosine_lr_matches_reference(cfg):
    for step in range(0, 25):
        got = cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.cosine_lr(cfg, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(64, 33)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32) * 1e-3,
              "c": rng.normal(size=(3, 4, 5)).astype(np.float32) * 50}
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors["c"] = tensors["c"].bfloat16()
    want = jopt.global_norm({**arrays, "c": jnp.asarray(arrays["c"], jnp.bfloat16)})
    np.testing.assert_allclose(global_norm(tensors).item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(global_norm(list(tensors.values())).item(),
                               float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# AdamW and Adafactor on carried-over parameters and state
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adamw-stablelm": ("stablelm-1.6b", {}, "adamw"),
    "adamw-qwen8": ("qwen2.5-3b", {"num_layers": 8}, "adamw"),
    "adafactor-stablelm": ("stablelm-1.6b", {}, "adafactor"),
    "adafactor-qwen8": ("qwen2.5-3b", {"num_layers": 8}, "adafactor"),
    "adafactor-mixtral": ("mixtral-8x7b", {}, "adafactor"),
}


def _opt_cfg(kind):
    return OptConfig(kind=kind, lr=1e-2, warmup=2, total_steps=10)


@pytest.fixture(scope="module")
def opt_reference():
    """case -> the reference's params and state after one step (the
    carried-over point), the three gradients after it, and the params,
    state and metrics after each of the three steps."""
    runs = {}

    def get(case):
        if case in runs:
            return runs[case]
        arch, over, kind = OPT_CASES[case]
        cfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
        opt_cfg = _opt_cfg(kind)
        params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(5)
        grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.05
                                         ).astype(np.float32), params)
                 for _ in range(4)]
        apply = jax.jit(lambda p, g, o: jtrain.apply_updates(p, g, o, opt_cfg))
        p, o, _ = apply(params, grads[0], jtrain.init_opt_state(params, opt_cfg))
        start = (_np(p), jax.tree.map(np.asarray, o))
        after = []
        for g in grads[1:]:
            p, o, m = apply(p, g, o)
            after.append((_np(p), _np(o), {k: float(v) for k, v in m.items()}))
        runs[case] = dict(cfg=cfg, start=start, grads=grads[1:], after=after)
        return runs[case]

    return get


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_steps_match_reference(opt_reference, case):
    ref = opt_reference(case)
    arch, over, kind = OPT_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    opt_cfg = _opt_cfg(kind)
    model = lm_params_from_arrays(cfg, ref["start"][0], device="cpu")
    state = opt_state_from_arrays(ref["start"][1], device="cpu")
    # the port's own zero state has the reference's leaves and shapes
    zero = opt_state_to_arrays(init_opt_state(model, opt_cfg))
    assert jax.tree.structure(zero) == jax.tree.structure(ref["start"][1])
    jax.tree.map(lambda a, b: np.testing.assert_equal(np.shape(a), np.shape(b)),
                 zero, ref["start"][1])
    for g, (p_want, o_want, m_want) in zip(ref["grads"], ref["after"]):
        grads = {n: torch.from_numpy(np.asarray(a))
                 for n, a in _reference_leaves(cfg, _np(g)).items()}
        model, state, m = apply_updates(model, grads, state, opt_cfg)
        for k, v in m_want.items():
            np.testing.assert_allclose(m[k].item(), v, rtol=1e-6)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **UPDATE_TOL),
                     lm_params_to_arrays(model), p_want)
        got = opt_state_to_arrays(state)
        assert int(got["step"]) == int(o_want["step"])
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **UPDATE_TOL),
                     got, o_want)


def test_adafactor_factors_the_stacked_leaves():
    """At 8 layers qwen's layer leaves are stacked: a norm scale is one
    (8, d) leaf, factored into (8,) and (d,) statistics, where one layer's
    (d,) scale alone would not be factored at all."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), num_layers=8)
    state = init_opt_state(LM(cfg, device="cpu"), _opt_cfg("adafactor"))
    d = cfg.d_model
    assert state["vr"]["blocks/0/pattern/0/norm1/scale"].shape == (8,)
    assert state["vc"]["blocks/0/pattern/0/norm1/scale"].shape == (d,)
    assert state["vr"]["final_norm/scale"].shape == (d,)
    assert state["vc"]["final_norm/scale"].shape == (1,)


# ---------------------------------------------------------------------------
# whole steps: microbatches, compression
# ---------------------------------------------------------------------------

def _tiny(registry):
    return dataclasses.replace(registry("stablelm-1.6b").reduced(), num_layers=2,
                               vocab_size=256)


@pytest.fixture(scope="module")
def step_reference():
    """(microbatches, compress) -> the reference's params after one step
    and its metrics, from its init on a batch of 8 x 32."""
    cfg = _tiny(jax_get_config)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k: np.asarray(v) for k, v in
             JaxTokenPipeline(cfg.padded_vocab, 8, 32, seed=2).batch_at(0).items()}
    opt_cfg = OptConfig(lr=1e-3, warmup=1, total_steps=10, clip_norm=0.0)
    runs = {}

    def get(mb, compress):
        if (mb, compress) not in runs:
            tcfg = TrainConfig(microbatches=mb, compress_grads=compress)
            step = jax.jit(jtrain.make_train_step(cfg, opt_cfg, tcfg))
            p, _, m = step(params, jtrain.init_opt_state(params, opt_cfg), batch)
            runs[mb, compress] = (_np(p), {k: float(v) for k, v in m.items()})
        return runs[mb, compress]

    return dict(arrays=_np(params), batch=batch, opt_cfg=opt_cfg, get=get)


def _port_step(ref, mb, compress):
    cfg = _tiny(get_config)
    model = lm_params_from_arrays(cfg, ref["arrays"], device="cpu").requires_grad_(True)
    tcfg = TrainConfig(microbatches=mb, compress_grads=compress)
    step = make_train_step(cfg, ref["opt_cfg"], tcfg)
    model, _, m = step(model, init_opt_state(model, ref["opt_cfg"]), ref["batch"])
    return model, {k: v.item() for k, v in m.items()}


@pytest.mark.parametrize("mb,compress", [(1, False), (4, False), (1, True)],
                         ids=["one", "four-microbatches", "compressed"])
def test_train_step_matches_reference(step_reference, mb, compress):
    want_p, want_m = step_reference["get"](mb, compress)
    model, m = _port_step(step_reference, mb, compress)
    for k in ("loss", "nll", "aux", "z"):
        assert abs(m[k] - want_m[k]) < 1e-5, (k, m[k], want_m[k])
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(m[k], want_m[k], rtol=1e-4)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=2e-3),
                 lm_params_to_arrays(model), want_p)


def test_microbatches_accumulate_in_float32(step_reference):
    """Four microbatches against one: the same loss, gradients summed in
    float32 buffers (float32 even for a bfloat16 model) and divided by 4."""
    cfg = dataclasses.replace(_tiny(get_config), dtype="bfloat16")
    model = lm_params_from_arrays(cfg, step_reference["arrays"], device="cpu")
    model.requires_grad_(True)
    batch = step_reference["batch"]
    g1, l1, m1 = grads_of(model, batch, cfg, TrainConfig())
    g4, l4, m4 = grads_of(model, batch, cfg, TrainConfig(microbatches=4))
    params = dict(model.named_parameters())
    assert all(g.dtype == params[n].dtype for n, g in g1.items())
    assert {p.dtype for p in params.values()} == {torch.bfloat16, torch.float32}
    assert all(g.dtype == torch.float32 for g in g4.values())
    assert abs(l1.item() - l4.item()) < 2e-2
    # the sum of four quarter-batch gradients, one by one
    parts = [grads_of(model, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()},
                      cfg, TrainConfig())[0] for i in range(4)]
    for n, g in g4.items():
        want = (((parts[0][n].float() + parts[1][n]) + parts[2][n]) + parts[3][n]) * 0.25
        assert torch.equal(g, want), n
    with pytest.raises(ValueError, match="microbatches"):
        grads_of(model, batch, cfg, TrainConfig(microbatches=3))


def test_compressed_grads_stay_close(step_reference):
    """int8 compression moves the loss not at all and the gradient norm
    by less than 20 % (the reference's check), and the step applies the
    quantised gradients: parameters differ from the uncompressed step."""
    model_c, m_c = _port_step(step_reference, 1, True)
    model_u, m_u = _port_step(step_reference, 1, False)
    assert abs(m_c["loss"] - m_u["loss"]) < 1e-5
    assert abs(m_c["grad_norm"] - m_u["grad_norm"]) / m_u["grad_norm"] < 0.2
    assert any(not torch.equal(a, b) for a, b in zip(model_c.parameters(),
                                                     model_u.parameters()))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_int8_quantisation_matches_reference():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=256).astype(np.float32),
              (rng.normal(size=(17, 9)) * 1e-5).astype(np.float32),
              np.asarray([-127.0, -1.0, 0.0, 1.0, 64.0, 127.0], np.float32),
              np.asarray([0.5, -0.5, 1.5, 2.5, -2.5, 127.0], np.float32),
              np.zeros(8, np.float32)):
        q, scale = quantize_int8(torch.from_numpy(x))
        jq, jscale = jcoll.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert scale.item() == float(jscale)
        back = dequantize_int8(q, scale)
        np.testing.assert_array_equal(back.numpy(),
                                      np.asarray(jcoll.dequantize_int8(jq, jscale)))
        # at most half a quantisation step from x
        assert np.abs(back.numpy() - x).max() <= scale.item() * 0.5 + 1e-6


def test_fake_quantize_grads_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "b": (rng.normal(size=(5,)) * 3).astype(np.float32)}
    got = fake_quantize_grads({"w": torch.from_numpy(tree["w"]),
                               "b": torch.from_numpy(tree["b"]).bfloat16()})
    want = jcoll.fake_quantize_grads({"w": jnp.asarray(tree["w"]),
                                      "b": jnp.asarray(tree["b"], jnp.bfloat16)})
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  np.asarray(want["b"], np.float32))
    as_list = fake_quantize_grads([torch.from_numpy(tree["w"])])
    assert torch.equal(as_list[0], got["w"])


def _psum_rule(parts):
    """The reference's rule in numpy: each shard quantised with its own
    scale, the integers summed, times the largest scale."""
    scales = [np.float32(np.abs(p).max() / np.float32(127.0) + np.float32(1e-30))
              for p in parts]
    qs = [np.clip(np.round(p / s), -127, 127).astype(np.int32)
          for p, s in zip(parts, scales)]
    return sum(qs).astype(np.float32) * max(scales)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_compressed_psum_over_shards(k):
    rng = np.random.default_rng(k)
    parts = [(rng.normal(size=(6, 5)) * (i + 1)).astype(np.float32) for i in range(k)]
    got = compressed_psum([torch.from_numpy(p) for p in parts])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _psum_rule(parts))
    # shards of one amax share a scale: the sum is then within the
    # quantisation error of the exact one
    same = [p / np.abs(p).max() for p in parts]
    got = compressed_psum([torch.from_numpy(p) for p in same]).numpy()
    assert np.abs(got - sum(same)).max() <= k * 0.5 / 127 + 1e-6
    if k == 1:   # one shard: the fake-quantize numerics in float32
        q, scale = jcoll.quantize_int8(jnp.asarray(parts[0]))
        np.testing.assert_array_equal(compressed_psum([torch.from_numpy(parts[0])]).numpy(),
                                      np.asarray(jcoll.dequantize_int8(q, scale)))


def test_compressed_psum_refusals():
    with pytest.raises(ValueError, match="at least one"):
        compressed_psum([])
    with pytest.raises(ValueError, match="equal shapes"):
        compressed_psum([torch.zeros(3), torch.zeros(4)])


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

PIPES = [dict(vocab=1000, batch=4, seq=16, seed=9, host=0, hosts=1),
         dict(vocab=1000, batch=4, seq=16, seed=9, host=1, hosts=2),
         dict(vocab=50_304, batch=2, seq=33, seed=0, host=3, hosts=4),
         dict(vocab=512, batch=3, seq=8, seed=123, host=0, hosts=1)]


@pytest.mark.parametrize("spec", PIPES, ids=[f"seed{p['seed']}-host{p['host']}"
                                             for p in PIPES])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-base", "phi-3-vision-4.2b"])
def test_pipeline_matches_reference(spec, arch):
    cfg = get_config(arch).reduced()
    args = (spec["vocab"], spec["batch"], spec["seq"])
    kw = dict(seed=spec["seed"], host_id=spec["host"], num_hosts=spec["hosts"],
              extras_fn=extras_fn_for(cfg))
    ours = TokenPipeline(*args, **kw)
    ref = JaxTokenPipeline(*args, **dict(kw, extras_fn=jax_extras_fn_for(
        jax_get_config(arch).reduced())))
    for step in (0, 1, 5, 1000):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_skip_and_prefetch():
    p1 = TokenPipeline(1000, 4, 16, seed=9)
    p2 = TokenPipeline(1000, 4, 16, seed=9)
    p2.skip_to(5)
    np.testing.assert_array_equal(p1.batch_at(5)["tokens"], next(iter(p2))["tokens"])
    np.testing.assert_array_equal(p1.batch_at(6)["tokens"], next(p2)["tokens"])
    # the prefetching thread yields the same stream
    p3 = TokenPipeline(1000, 4, 16, seed=9).start()
    try:
        for step in range(4):
            np.testing.assert_array_equal(next(p3)["tokens"],
                                          p1.batch_at(step)["tokens"])
    finally:
        p3.stop()
    other = TokenPipeline(1000, 4, 16, seed=9, host_id=1, num_hosts=2)
    assert not np.array_equal(other.batch_at(5)["tokens"], p1.batch_at(5)["tokens"])


# ---------------------------------------------------------------------------
# fault handling
# ---------------------------------------------------------------------------

def test_preemption_guard_sees_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert not g.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert g.should_stop
    assert signal.getsignal(signal.SIGTERM) is prev


def test_watchdog_fires_and_stays_quiet():
    fired = []
    with StepWatchdog(0.05, on_timeout=lambda: fired.append(1)) as w:
        time.sleep(0.15)
    assert w.timed_out and fired
    with StepWatchdog(5.0, on_timeout=lambda: fired.append(2)) as w:
        pass
    time.sleep(0.05)
    assert not w.timed_out and fired == [1]
