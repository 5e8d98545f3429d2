"""PyTorch port, the training loss and its gradients on the CPU: the reduced
configs of all ten archs against the JAX package's ``loss_fn`` under
``jax.value_and_grad`` on the same parameters (the reference's
``init_params`` through ``repro_torch.convert``) and batches.

float32: the loss, nll, aux and z within 1e-5; each gradient leaf (in the
reference's layout, through ``lm_grads_to_arrays``) within 1e-4 of its
largest entry; the parameters after two AdamW steps within 2e-3 (the
reference's own bar, ``tests/test_train.py``: Adam's normalised update
turns near-zero gradients into steps of about the learning rate, so
float32 noise there moves a parameter by up to lr).  bfloat16: the loss
within 1e-2.  The sequence (24) is not a whole number of the loss's
chunks (16).  Layer recomputation (off, ``"full"``, ``"dots"``) gives
the same gradients bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import repro.models as jmodels
import repro.train as jtrain
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import lm_grads_to_arrays, lm_params_from_arrays, \
    lm_params_to_arrays
from repro_torch.models import init_params
from repro_torch.models import layers as tlayers
from repro_torch.train import (
    OptConfig,
    TrainConfig,
    grads_of,
    init_opt_state,
    loss_fn,
    make_train_step,
)

B, S = 2, 24
TCFG = TrainConfig(ce_chunk=16)
OPT = OptConfig(lr=1e-3, warmup=1, total_steps=10)
LOSS_TOL, GRAD_TOL, PARAM_TOL, BF16_LOSS_TOL = 1e-5, 1e-4, 2e-3, 1e-2
ARCHS = list_archs()


def _cfg(registry, arch, dtype="float32", **over):
    return dataclasses.replace(registry(arch).reduced(), dtype=dtype, **over)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _reference_run(arch):
    """The reference's float32 params, loss and metrics, gradients, the
    params after two AdamW steps and their metrics; its bf16 loss."""
    cfg = _cfg(jax_get_config, arch)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.loss_fn(p, b, cfg, TCFG), has_aux=True))
    apply = jax.jit(lambda p, g, o: jtrain.apply_updates(p, g, o, OPT))
    (loss, m), grads = vg(params, batch)
    out = dict(arrays=_np(params), batch=batch, grads=_np(grads),
               metrics={"loss": float(loss), **{k: float(v) for k, v in m.items()}})
    p, o, steps = params, jtrain.init_opt_state(params, OPT), []
    for _ in range(2):
        (_, _), g = vg(p, batch)
        p, o, om = apply(p, g, o)
        steps.append({k: float(v) for k, v in om.items()})
    out.update(stepped=_np(p), step_metrics=steps)
    bcfg = _cfg(jax_get_config, arch, "bfloat16")
    # the same draws, cast to bfloat16 as the port casts the float32 arrays
    out["bf16_loss"] = float(jax.jit(lambda p, b: jtrain.loss_fn(p, b, bcfg, TCFG)[0])(
        jmodels.init_params(bcfg, jax.random.PRNGKey(0)), batch))
    return out


@pytest.fixture(scope="module")
def reference():
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = _reference_run(arch)
        return runs[arch]

    return get


def _model(cfg, arrays):
    model = lm_params_from_arrays(cfg, arrays, device="cpu")
    return model.requires_grad_(True)


def _assert_leaves(got, want, rel):
    """Every leaf within ``rel`` of its largest entry (and exact zeros
    where the reference's leaf is all zeros)."""
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        assert g.shape == w.shape, path
        bar = rel * np.abs(w).max() if np.abs(w).max() > 0 else 1e-12
        err = np.abs(g - w).max()
        assert err <= bar, (jax.tree_util.keystr(path), err, bar)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch):
    ref = reference(arch)
    cfg = _cfg(get_config, arch)
    model = _model(cfg, ref["arrays"])
    grads, loss, m = grads_of(model, ref["batch"], cfg, TCFG)
    got = {"loss": loss.item(), **{k: v.item() for k, v in m.items()}}
    for k, v in ref["metrics"].items():
        assert abs(got[k] - v) < LOSS_TOL, (k, got[k], v)
    back = lm_grads_to_arrays(model, grads)
    assert jax.tree.structure(back) == jax.tree.structure(ref["grads"])
    _assert_leaves(back, ref["grads"], GRAD_TOL)
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_steps_match_reference(reference, arch):
    ref = reference(arch)
    cfg = _cfg(get_config, arch)
    model = _model(cfg, ref["arrays"])
    step = make_train_step(cfg, OPT, TCFG)
    opt = init_opt_state(model, OPT)
    for want in ref["step_metrics"]:
        model, opt, m = step(model, opt, ref["batch"])
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), want[k], rtol=1e-5)
    assert int(opt["step"]) == 2
    got = lm_params_to_arrays(model)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0,
                                                         atol=PARAM_TOL),
                 got, ref["stepped"])
    moved = max(np.abs(g - w).max() for g, w in zip(
        jax.tree.leaves(got), jax.tree.leaves(ref["arrays"])))
    assert moved > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_reference(reference, arch):
    ref = reference(arch)
    cfg = _cfg(get_config, arch, "bfloat16")
    model = _model(cfg, ref["arrays"])
    with torch.no_grad():
        loss, _ = loss_fn(model, ref["batch"], cfg, TCFG)
    assert abs(loss.item() - ref["bf16_loss"]) < BF16_LOSS_TOL


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b", "mamba2-2.7b",
                                  "deepseek-v2-lite-16b", "whisper-base"])
def test_remat_policies_give_the_same_gradients(arch):
    """Off, "full" and "dots" recomputation: gradients, loss and MoE drop
    counts bit for bit (a recomputed layer records its drops once)."""
    outs = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = _cfg(get_config, arch, remat=remat, remat_policy=policy)
        model = lm_params_from_arrays(cfg, _seeded_arrays(arch), device="cpu")
        model.requires_grad_(True)
        grads, loss, _ = grads_of(model, _batch(cfg), cfg, TCFG)
        drops = [int(lay.ffn.dropped) for lay in model.layers if lay.moe]
        outs.append((grads, loss, drops))
    for grads, loss, drops in outs[1:]:
        assert torch.equal(loss, outs[0][1])
        assert drops == outs[0][2]
        for n, g in grads.items():
            assert torch.equal(g, outs[0][0][n]), n


def _seeded_arrays(arch):
    cfg = _cfg(get_config, arch)
    return lm_params_to_arrays(init_params(cfg, torch.Generator().manual_seed(3),
                                           device="cpu"))


def test_remat_recomputes_the_layers(monkeypatch):
    """With remat on, a layer's activations are not kept: the backward
    runs each layer's forward again."""
    calls = []
    plain = tlayers.MLP.forward
    monkeypatch.setattr(tlayers.MLP, "forward",
                        lambda self, x: calls.append(1) or plain(self, x))
    counts = {}
    for remat in (False, True):
        cfg = _cfg(get_config, "qwen2.5-3b", remat=remat)
        model = lm_params_from_arrays(cfg, _seeded_arrays("qwen2.5-3b"), device="cpu")
        model.requires_grad_(True)
        calls.clear()
        grads_of(model, _batch(cfg), cfg, TCFG)
        counts[remat] = len(calls)
    assert counts == {False: cfg.num_layers, True: 2 * cfg.num_layers}


@pytest.mark.parametrize("chunk", [7, 16, 24, 512])
def test_loss_does_not_depend_on_the_chunk(reference, chunk):
    """Whole chunks, a remainder chunk, one chunk: the same loss and
    gradients to float32 rounding."""
    ref = reference("qwen2.5-3b")
    cfg = _cfg(get_config, "qwen2.5-3b")
    model = _model(cfg, ref["arrays"])
    grads, loss, m = grads_of(model, ref["batch"], cfg, TrainConfig(ce_chunk=chunk))
    assert abs(loss.item() - ref["metrics"]["loss"]) < LOSS_TOL
    _assert_leaves(lm_grads_to_arrays(model, grads), ref["grads"], GRAD_TOL)


def test_tied_head_gradient_sums_both_uses(reference):
    """qwen ties its head to the embedding: the embedding's gradient is the
    lookup's plus the head's, as in the reference."""
    ref = reference("qwen2.5-3b")
    cfg = _cfg(get_config, "qwen2.5-3b")
    assert cfg.tie_embeddings
    model = _model(cfg, ref["arrays"])
    grads, _, _ = grads_of(model, ref["batch"], cfg, TCFG)
    g = grads["embed"].numpy()
    want = ref["grads"]["embed"]
    np.testing.assert_allclose(g, want, rtol=0, atol=GRAD_TOL * np.abs(want).max())
    # the head's part alone is most of it; rows of unseen tokens get only it
    unseen = np.setdiff1d(np.arange(cfg.padded_vocab), ref["batch"]["tokens"])
    assert np.abs(g[unseen]).max() > 0


def test_train_step_refuses_a_frozen_model(reference):
    ref = reference("qwen2.5-3b")
    cfg = _cfg(get_config, "qwen2.5-3b")
    model = lm_params_from_arrays(cfg, ref["arrays"], device="cpu")
    with pytest.raises(ValueError, match="requires_grad_"):
        grads_of(model, ref["batch"], cfg, TCFG)
