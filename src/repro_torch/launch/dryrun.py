"""Multi-pod dry run: trace every (architecture x input shape) cell at full
width and depth on the production meshes, per card, and record its
memory, its costs and the three roofline terms against one H100's numbers
(the JAX package's ``launch/dryrun.py``).  Nothing is allocated: the step
runs on fake tensors (``FakeTensorMode``), the meshes are ``DeviceMesh``
objects over a fake process group (:mod:`repro_torch.launch.mesh`) and a
layout is a :class:`~repro_torch.distributed.sharding.MeshSharding` from
the logical-axis rules.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both \\
      --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --mesh single

What a cell records, per card (``*_per_device``; the other memory keys are
that times the cards, as the reference's module totals are):

* argument bytes: the shards of the parameters (ZeRO-3 weight sharding
  with ``cfg.fsdp``), the optimizer state, the batch and, for decode, the
  cache, each from its placements (exact); alias bytes what the step
  donates (parameters and optimizer state for train, the cache for
  decode); output bytes the donated buffers and the step's own outputs;
* FLOPs (PyTorch's ``FlopCounterMode``: matmuls), bytes accessed (every
  aten op's inputs plus outputs, views excepted: fusion-blind like the
  reference's CPU cost model, so the memory term is an upper bound) and
  temp bytes (the peak of live tensors the step allocates, less what it
  returns), from one trace of the step at the widths the rules leave one
  card;
* collective result bytes and counts by kind, from the cell's placements;
* the roofline of :mod:`repro_torch.roofline.analysis`.

One card's step (the global step is never traced and divided):

==================  ====================================================
batch               B over the batch axes ``_batch_sharding`` keeps
parameters          each leaf's block over the model axis (the rules'
                    divisibility and one-axis-per-spec guards); FSDP's
                    data-axis shard is gathered for the step
kv heads            sharded with the heads when the rule resolves; when
                    only the query heads shard, the card computes the kv
                    heads its queries read, ``max(1, KV * H_l / H)``
Mamba-2             train: the whole block on the card's batch rows,
                    its whole sequence, every leaf gathered (what the
                    meshed step runs on local tensors); prefill and
                    decode (no meshed serving runs): by heads, ``di / m``
                    inner width (``P`` per head), B and C (one group)
                    whole
sequence            with ``rules["seq"] = "model"`` the activations
                    shard along the sequence between the products, not
                    the work: the trace keeps the tensor-parallel widths
                    (a core's S / m query rows against all S keys is the
                    work of H / m heads over S rows)
MoE, experts split  ``E / m`` experts with the global slots per expert;
                    the router is cut to them, ``top_k`` to at most them
optimizer           AdamW / Adafactor on the card's parameter shards
                    (FSDP's, when on), gradients reduce-scattered to them
long_500k           the cache's positions shard over the model axis
                    (``kv_seq``); the trace attends the card's H / m
                    heads over all positions, the same attention work
                    as all heads over S / m
==================  ====================================================

Collectives, per card, each counted at its result's bytes (``uses`` is 1
for prefill and decode; for train the forward, remat's recompute and the
backward):

==================  ====================================================
all-reduce          the output of each product whose contracted
                    dimension shards over the model axis (attention's
                    ``wo``, the MLPs' and experts' ``w_down``, Mamba's
                    ``out_proj``, the vocab-sharded embedding lookup),
                    once per use; train: each gradient shard over the
                    batch axes its leaf does not shard over
all-gather          each FSDP-sharded weight, once per use; train: each
                    sequence chunk's float32 logits (its rows by the
                    padded vocabulary) where the head shards the
                    vocabulary, in the forward and the chunk's recompute
reduce-scatter      train: each FSDP-sharded weight's gradient
all-to-all          two per MoE layer per use when the experts shard:
                    the card's dispatched tokens out and back
kv_seq (long_500k)  per attention layer: an all-gather of the query and
                    an all-reduce of the float32 partial output with its
                    max and sum
Mamba-2 (train)     each leaf the model axis shards gathered whole, once
                    per use (no all-reduce of ``out_proj``'s output; the
                    model axis' ranks compute the same gradients)
==================  ====================================================

With the sequence sharded over the model axis (train and prefill of a
``seq_shard`` config, the axis above one card and dividing the
sequence), what the meshed step does, per use (each layer's
redistributions are explicit, ``layers._seq_for``, so DTensor moves
nothing on its own at a product):

==================  ====================================================
all-gather          the input (T, d) of each mixer (attention, MLA,
                    Mamba-2) and of each MLP, once (its products'
                    input); a GQA core's k (B, S, KV, hd), and v where
                    the kv heads shard; an MoE layer's tokens (its
                    groups cut across the sequence); the loss's head
                    whole, once; where ``wo`` or ``w_down`` does not
                    shard its rows, its input whole
all-to-all          the queries (heads to sequence) at their ``"seq"``
                    site and the core's output back before ``wo``; the
                    MLP's hidden state (its width to sequence) at its
                    site and back before ``w_down``
reduce-scatter      in place of the all-reduce of each product whose
                    contracted dimension shards over model (``wo``,
                    ``w_down``, the embedding's lookup) and of an MoE
                    layer's partial output: the sum lands on the
                    sequence's split; train: the head's gradient
all-reduce          train: the gradient of each leaf the model axis
                    does not shard (a partial sum over the sequence's
                    split), Mamba-2's aside (its output is whole along
                    the sequence: the backward gathers its gradient)
==================  ====================================================

Not modelled: the scalar sums of the loss (floats a step).  The MoE
layers keep the reference's all-to-all dispatch above, which the port's
meshed step does not run (it gathers ZeRO-3's expert shards).  A cell that raises is a
record with its error and traceback; the CLI exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import SHAPES, get_config, list_archs, shape_cells
from ..convert import reference_layout, use_scan
from ..distributed.sharding import (
    MeshSharding,
    axis_env,
    make_rules,
    mesh_axes,
    replicated,
    sharding_for_spec,
    tree_shardings,
)
from ..models import layers as L
from ..models.model import (
    LM,
    _causal_pass,
    _logits,
    _param_leaves,
    cache_axes,
    cache_specs,
    forward_decode,
)
from ..roofline.analysis import COLLECTIVES, analyze, model_flops_for
from ..train.optimizer import OptConfig, _factored_dims, apply_updates, init_opt_state
from ..train.train_step import TrainConfig, grads_of
from .mesh import make_production_mesh

_ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4}


def _nbytes(shape, dtype: str) -> int:
    return math.prod(shape) * _ITEMSIZE[dtype]


def opt_config_for(cfg) -> OptConfig:
    # Adafactor for the 100B+ archs (AdamW moments would not fit per card)
    big = cfg.param_count() > 60e9
    return OptConfig(kind="adafactor" if big else "adamw")


def reference_specs(cfg) -> dict:
    """The reference's parameter leaves ``{path: (shape, dtype, axes)}``
    (``convert.reference_layout``): a scan group's leaf stacked along a
    leading layer axis, its axes led by ``None``."""
    leaves = _param_leaves(cfg)
    out = {}
    for path, (names, stacked) in reference_layout(cfg).items():
        shape, dt, axes = leaves[names[0]]
        out[path] = (((len(names), *shape), dt, (None, *axes)) if stacked
                     else (shape, dt, axes))
    return out


def opt_specs(p_specs: dict, opt_cfg: OptConfig) -> dict:
    """The optimizer state's leaves, as ``train.optimizer.init_opt_state``
    makes them on the reference's layout (float32 moments)."""
    out = {"step": ((), "int32", ())}
    if opt_cfg.kind == "adamw":
        for key in ("m", "v"):
            out[key] = {p: (s, "float32", ax) for p, (s, _, ax) in p_specs.items()}
        return out
    out["vr"], out["vc"] = {}, {}
    for p, (s, _, ax) in p_specs.items():
        d = _factored_dims(s)
        out["vr"][p] = (s if d is None else s[:d[1]] + s[d[1] + 1:], "float32", ax)
        out["vc"][p] = ((1,) if d is None else s[:d[0]] + s[d[0] + 1:], "float32", ax)
    return out


def opt_shardings(o_specs, p_sh, mesh, p_specs=None, rules=None, fsdp=False):
    """m/v mirror the param shardings; Adafactor's factored vr/vc inherit the
    parent param's axes minus the factored-out dim (a replicated (R, d, h)
    stat for a 340B model would not fit)."""
    out = {"step": replicated(mesh)}
    for key in o_specs:
        if key == "step":
            continue
        if key in ("m", "v"):
            out[key] = p_sh
            continue
        drop = -1 if key == "vr" else -2

        def stat_sh(spec, drop=drop):
            shape, _dt, axes = spec
            if len(shape) < 2:
                return replicated(mesh)
            keep = [i for i in range(len(shape)) if i != len(shape) + drop]
            return sharding_for_spec(tuple(shape[i] for i in keep),
                                     tuple(axes[i] for i in keep), mesh, rules, fsdp)

        out[key] = {p: stat_sh(s) for p, s in p_specs.items()}
    return out


def _batch_sharding(mesh, B: int, rules=None) -> MeshSharding:
    """Shard batch per rules['batch'] (default (pod,data)); drops trailing
    axes until divisible, replicates as a last resort."""
    want = (rules or {}).get("batch", ("pod", "data")) or ()
    if not isinstance(want, tuple):
        want = (want,)
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in want if a in sizes)
    while axes:
        if B % math.prod(sizes[a] for a in axes) == 0:
            return MeshSharding(mesh, (axes if len(axes) > 1 else axes[0], None))
        axes = axes[:-1]
    return MeshSharding(mesh, (None, None))


def _extras_specs(cfg, B: int) -> dict:
    if cfg.frontend == "audio_stub":
        return {"frames": ((B, cfg.encoder_seq, cfg.d_model), "bfloat16")}
    if cfg.frontend == "vision_stub":
        return {"patch_embeds": ((B, cfg.frontend_tokens, cfg.d_model), "bfloat16")}
    return {}


def _extras_structs(cfg, B, mesh, bsh):
    """The frontend stub's input ``({name: (shape, dtype)}, {name:
    sharding})`` with the batch's layout, or None."""
    st = _extras_specs(cfg, B)
    if not st:
        return None
    return st, {k: MeshSharding(mesh, (bsh.spec[0], None, None)) for k in st}


def batch_specs(cfg, shape, mesh, rules):
    B, S = shape.global_batch, shape.seq_len
    structs = {"tokens": ((B, S), "int32"), "labels": ((B, S), "int32")}
    bsh = _batch_sharding(mesh, B, rules)
    sh = {"tokens": bsh, "labels": bsh}
    extras = _extras_structs(cfg, B, mesh, bsh)
    if extras:
        structs.update(extras[0])
        sh.update(extras[1])
    return structs, sh


def _spec_leaves(tree, axes) -> list:
    """[(shape, dtype, axes)] of a spec tree (leaves ``(shape, dtype)``)
    beside its axes tree."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], str):
        return [(tree[0], tree[1], axes)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _spec_leaves(tree[k], axes[k])]
    return [x for t, a in zip(tree, axes) for x in _spec_leaves(t, a)]


def _shard_bytes(leaves, mesh, rules, fsdp=False) -> int:
    return sum(_nbytes(sharding_for_spec(s, ax, mesh, rules, fsdp).shard_shape(s), dt)
               for s, dt, ax in leaves)


# ---------------------------------------------------------------------------
# one card's step on fake tensors
# ---------------------------------------------------------------------------

# allocations that neither read nor write their memory
_UNWRITTEN = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
              torch.ops.aten.empty_strided.default}


class _Counter(TorchDispatchMode):
    """The FLOPs of the products (``torch.utils.flop_counter``'s
    registry), the bytes accessed (inputs plus outputs of each non-view
    aten op) and the live bytes of the storages the traced ops allocate,
    with their peak.  (``FlopCounterMode`` itself is not used: its module
    tracking holds the recomputed activations of a remat layer in
    reference cycles, which would raise the peak.)"""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: dict = {}

    def _free(self, key):
        self.live -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if outs and not func.is_view and func not in _UNWRITTEN:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._held:
                continue           # written in place, or a view
            self._held[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return out


def count_ops(step) -> dict:
    """Run ``step()`` (on fake tensors) under :class:`_Counter`:
    ``{"flops", "bytes accessed", "temp_bytes"}``, the temp bytes the
    peak of what the step allocates less what it returns."""
    counter = _Counter()
    # cyclic garbage would be freed whenever the collector happened to
    # run: collect before, and not during, so that the peak repeats
    gc.collect()
    gc.disable()
    try:
        with counter:
            out = step()
            end = counter.live
            del out
    finally:
        gc.enable()
    return {"flops": float(counter.flops), "bytes accessed": float(counter.bytes),
            "temp_bytes": float(counter.peak - end)}


class _Shards:
    """One card's blocks of the parameters, as the optimizer reads a
    model: ``cfg``, ``device`` and ``named_parameters()``."""

    def __init__(self, cfg, params: dict, device):
        self.cfg, self.device, self._params = cfg, device, params

    def named_parameters(self):
        return iter(self._params.items())


def _card_model(cfg, mesh, rules, device, whole_mamba: bool = False) -> LM:
    """``LM(cfg)`` with every parameter replaced by one card's block (the
    rules of the module docstring) and the modules' widths set to match;
    under a ``FakeTensorMode`` nothing is allocated.  ``whole_mamba``
    keeps the Mamba-2 leaves whole (the meshed training step gathers
    them)."""
    model = LM(cfg, device)
    shapes = {n: list(s if whole_mamba and ".mamba." in n else
                      sharding_for_spec(s, ax, mesh, rules).shard_shape(s))
              for n, (s, _, ax) in _param_leaves(cfg).items()}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, L.Attention):
            H, KV = cfg.num_heads, cfg.num_kv_heads
            H_l, KV_l = shapes[pre + "wq"][1], shapes[pre + "wk"][1]
            if KV_l == KV and H_l < H:
                KV_l = max(1, KV * H_l // H)
                for leaf, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
                    if pre + leaf in shapes:
                        shapes[pre + leaf][dim] = KV_l
            mod.groups = H_l // KV_l
        elif isinstance(mod, L.Mamba2):
            di = shapes[pre + "out_proj"][0]
            H_l = di // mod.P
            shapes[pre + "in_proj"][1] = 2 * di + 2 * mod.N + H_l
            shapes[pre + "conv_w"][1] = shapes[pre + "conv_b"][0] = di + 2 * mod.N
            for leaf in ("A_log", "D", "dt_bias"):
                shapes[pre + leaf][0] = H_l
            shapes[pre + "out_norm.scale"][0] = di
            mod.di, mod.H = di, H_l
        elif isinstance(mod, L.MoE):
            E, K = cfg.n_experts, cfg.top_k
            E_l = shapes[pre + "experts.w_up"][0]
            if E_l < E:
                K_l = min(K, E_l)
                shapes[pre + "router"][1] = E_l
                mod.cfg = dataclasses.replace(
                    cfg, n_experts=E_l, top_k=K_l,
                    capacity_factor=cfg.capacity_factor * K * E_l / (E * K_l))
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        for leaf, p in list(mod._parameters.items()):
            mod._parameters[leaf] = nn.Parameter(
                torch.empty(shapes[pre + leaf], dtype=p.dtype, device=p.device),
                requires_grad=False)
    return model


def _card_cache(cfg, model: LM, B: int, slots: int, device) -> dict:
    """Zeroed cache buffers at the card model's widths."""
    dt = L.torch_dtype(cfg.dtype)
    layers = []
    for blk in model.layers:
        if hasattr(blk, "mamba"):
            m = blk.mamba
            layers.append({"h": torch.zeros(B, m.H, m.P, m.N, device=device),
                           "conv": torch.zeros(B, m.K - 1, m.di + 2 * m.N, dtype=dt,
                                               device=device)})
        elif cfg.attention == "mla":
            layers.append({"ckv": torch.zeros(B, slots, cfg.kv_lora_rank, dtype=dt,
                                              device=device),
                           "krope": torch.zeros(B, slots, cfg.qk_rope_head_dim,
                                                dtype=dt, device=device)})
        else:
            kv = (B, slots, blk.attn.wk.shape[1], cfg.hd)
            layers.append({"k": torch.zeros(kv, dtype=dt, device=device),
                           "v": torch.zeros(kv, dtype=dt, device=device)})
    return {"layers": layers}


def _slots(cfg, S: int) -> int:
    return min(S, cfg.window) if cfg.attention == "swa" else S


def _card_batch(cfg, shape, mesh, rules):
    """(B per card, tokens a row): the batch's block over its axes."""
    bsh = _batch_sharding(mesh, shape.global_batch, rules)
    B_l = bsh.shard_shape((shape.global_batch, 1))[0]
    return B_l, (shape.seq_len if shape.kind != "decode" else 1)


def trace_step(cfg, shape, mesh, rules, tcfg: TrainConfig | None = None) -> dict:
    """One card's step of ``cfg`` on ``shape`` under ``FakeTensorMode``:
    ``{"flops", "bytes accessed", "temp_bytes"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = torch.device("cpu")
    B, S = _card_batch(cfg, shape, mesh, rules)
    dt = L.torch_dtype(cfg.dtype)
    with FakeTensorMode():
        model = _card_model(cfg, mesh, rules, dev, whole_mamba=shape.kind == "train")
        # the frontend stubs' embeddings arrive in the model's dtype here
        # (the reference declares them bf16, as the argument bytes count them)
        extras = {k: torch.empty(s, dtype=dt, device=dev)
                  for k, (s, _) in _extras_specs(cfg, B).items()} or None
        if shape.kind == "train":
            opt_cfg = opt_config_for(cfg)
            model.requires_grad_(True)
            shards = _Shards(cfg, {
                n: torch.empty(sharding_for_spec(s, ax, mesh, rules, cfg.fsdp)
                               .shard_shape(s), dtype=L.torch_dtype(d), device=dev)
                for n, (s, d, ax) in _param_leaves(cfg).items()}, dev)
            state = init_opt_state(shards, opt_cfg)
            batch = {"tokens": torch.zeros(B, S, dtype=torch.int32, device=dev),
                     "labels": torch.zeros(B, S, dtype=torch.int32, device=dev),
                     **(extras or {})}

            def step():        # make_train_step's, the update on the shards
                grads, loss, m = grads_of(model, batch, cfg, tcfg or TrainConfig())
                del grads          # reduce-scattered onto the card's shards
                g = {n: torch.empty_like(p) for n, p in shards.named_parameters()}
                return loss, m, apply_updates(shards, g, state, opt_cfg)[2]
        elif shape.kind == "prefill":
            tokens = torch.zeros(B, S, dtype=torch.int32, device=dev)

            @torch.no_grad()
            def step():      # forward_prefill with the card's cache
                caches = _card_cache(cfg, model, B, _slots(cfg, S), dev)["layers"]
                x, enc_kv, _ = _causal_pass(model, tokens.long(), cfg, extras, caches)
                return _logits(model, x[:, -1:], cfg)[:, 0], caches, enc_kv
        else:
            slots = _slots(cfg, shape.seq_len)
            cache = _card_cache(cfg, model, B, slots, dev)
            cache["pos"] = slots - 1
            cache["enc_kv"] = None
            if cfg.encoder_layers:
                cache["enc_kv"] = [
                    tuple(torch.zeros(B, cfg.encoder_seq, blk.cross.wk.shape[1],
                                      cfg.hd, dtype=dt, device=dev) for _ in "kv")
                    for blk in model.layers]
            token = torch.zeros(B, 1, dtype=torch.int32, device=dev)

            def step():
                return forward_decode(model, token, cache, cfg)

        return count_ops(step)


def _pattern_period(cfg) -> int:
    period = 1
    if cfg.attn_every:
        period = period * cfg.attn_every // math.gcd(period, cfg.attn_every)
    if cfg.n_experts and cfg.moe_every > 1:
        period = period * cfg.moe_every // math.gcd(period, cfg.moe_every)
    return period


def _probe_costs(cfg, shape, mesh, rules, tcfg=None):
    """Tracing every layer of a deep model at 4k-32k tokens would run
    Mamba-2's chunk loop in each of them: trace two shallow variants (1
    and 2 pattern periods) and extrapolate linearly in num_layers — exact
    for the periodic stack, the intercept carrying embed/head/loss.
    Returns the extrapolated :func:`trace_step` dict, or None when the
    model is too shallow to probe (then it is traced whole)."""
    if not use_scan(cfg):
        return None
    period = _pattern_period(cfg)
    fd = cfg.first_dense
    n1, n2 = fd + period, fd + 2 * period
    if cfg.num_layers <= n2:
        return None
    a, b = (trace_step(dataclasses.replace(cfg, num_layers=n), shape, mesh, rules, tcfg)
            for n in (n1, n2))
    L_ = cfg.num_layers

    def extrap(va, vb):
        slope = (vb - va) / (n2 - n1)
        return max(va + slope * (L_ - n1), 0.0)

    return {k: extrap(a[k], b[k]) for k in a}


# ---------------------------------------------------------------------------
# collectives and memory from the placements
# ---------------------------------------------------------------------------

def _contracted(name: str, ndim: int) -> tuple:
    """The dimensions a product contracts of a weight leaf."""
    if ndim < 2 or name.endswith("conv_w"):
        return ()                  # elementwise, or the depthwise conv
    if name.endswith(".wo"):
        return (0, 1)              # (H, hd, d)
    if ".experts." in name:
        return (1,)                # (E, in, out): E is a batch dimension
    return (0,)                    # embed's lookup contracts the vocab


def _used(name: str, kind: str) -> bool:
    """Whether a step of ``kind`` reads the leaf: decode reads neither the
    encoder, nor the cross-attention's kv projections (their keys and
    values are in the cache), nor the patch projection."""
    return kind != "decode" or not (name.startswith("encoder.") or name == "patch_proj"
                                    or ".cross.wk" in name or ".cross.wv" in name)


def _seq_parallel(cfg, shape, mesh, rules) -> bool:
    """Whether the step shards the sequence over the model axis: the
    rules put ``"seq"`` there (``seq_shard`` configs), the axis holds
    more than one card and the sequence divides over it (the rules'
    guard); decode's one token never splits."""
    m = mesh_axes(mesh).get("model", 1)
    return (shape.kind != "decode" and rules.get("seq") == "model" and m > 1
            and shape.seq_len % m == 0)


def count_collectives(cfg, shape, mesh, rules, tcfg: TrainConfig | None = None) -> dict:
    """One card's collectives by kind (result bytes), with ``counts``: the
    rules of the module docstring (``tcfg``'s ``ce_chunk`` sets how many
    pieces the loss gathers its logits in)."""
    sizes = mesh_axes(mesh)
    kind = shape.kind
    uses = 2 + int(cfg.remat) if kind == "train" else 1
    B, S = _card_batch(cfg, shape, mesh, rules)
    T, act = B * S, _ITEMSIZE[cfg.dtype]
    T_enc = B * cfg.encoder_seq
    # a collective over an axis of one card moves nothing
    split = {a for a, n in sizes.items() if n > 1}
    batch_axes = _batch_sharding(mesh, shape.global_batch, rules).axes_used() & split
    sp = _seq_parallel(cfg, shape, mesh, rules)
    m = sizes.get("model", 1)
    out = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}

    def add(k, nbytes, n=1):
        out[k] += float(nbytes) * n
        counts[k] += n

    from ..models.layers import moe_capacity

    G, cap = moe_capacity(cfg, T) if cfg.n_experts else (0, 0)
    E_l = cfg.n_experts
    head = "embed" if cfg.tie_embeddings else "lm_head"
    for name, (shp, dt, axes) in _param_leaves(cfg).items():
        if not _used(name, kind):
            continue
        sh = sharding_for_spec(shp, axes, mesh, rules, cfg.fsdp)
        shard = _nbytes(sh.shard_shape(shp), dt)
        used = sh.axes_used() & split
        spec = sh.spec + (None,) * (len(shp) - len(sh.spec))
        dims = _contracted(name, len(shp))
        on_model = "model" in split and any(
            s == "model" or (isinstance(s, tuple) and "model" in s)
            for i, s in enumerate(spec) if i in dims)
        mamba = ".mamba." in name and kind == "train"
        if ".experts." in name:
            E_l = sh.shard_shape(shp)[0]
            rows = G * E_l * cap
        elif name.startswith("encoder.") or name.endswith((".cross.wk", ".cross.wv")):
            rows = T_enc
        else:
            rows = T
        if mamba:
            # the meshed step gathers every leaf of the block whole
            if "model" in used:
                add("all-gather", shard * m, uses)
        elif on_model:
            width = math.prod(s for i, s in enumerate(shp)
                              if i not in dims and not (".experts." in name and i == 0))
            if sp and ".experts." not in name:
                # the sum lands on the sequence's split
                add("reduce-scatter", rows * width * act // m, uses)
            elif not sp:
                add("all-reduce", rows * width * act, uses)
        if sp and name == head and "model" in used:
            # the loss's head, gathered whole once for the rank's rows
            add("all-gather", shard * m)
            if kind == "train":
                add("reduce-scatter", shard)
        elif kind == "train" and name == head and "model" in used:
            # the loss gathers each sequence chunk's float32 logits whole
            # over the vocabulary, in the forward and the chunk's recompute
            c = min((tcfg or TrainConfig()).ce_chunk, S)
            add("all-gather", B * c * cfg.padded_vocab * 4, 2 * (S // c))
            if S % c:
                add("all-gather", B * (S % c) * cfg.padded_vocab * 4, 2)
        if "data" in used:
            add("all-gather", shard * sizes["data"], uses)
            if kind == "train":
                add("reduce-scatter", shard)
        if kind == "train" and batch_axes - used:
            add("all-reduce", shard)
        if kind == "train" and sp and "model" not in used and not mamba:
            add("all-reduce", shard)        # a partial sum over the sequence's split
    d = cfg.d_model
    if sp:
        def sharded(leaf):        # whether a leaf shards over the model axis
            shp, _, axes = _param_leaves(cfg)[leaf]
            return "model" in sharding_for_spec(shp, axes, mesh, rules).axes_used()

        def mlp(pre, f):          # a dense MLP or the shared experts
            add("all-gather", T * d * act, uses)                  # its input
            if sharded(pre + "w_up"):
                add("all-to-all", T * f * act // m, uses)         # ffn -> seq site
            add("all-to-all" if sharded(pre + "w_down") else "all-gather",
                T * f * act // (m if sharded(pre + "w_down") else 1), uses)

        for i in range(cfg.num_layers):
            pre = f"layers.{i}."
            add("all-gather", T * d * act, uses)    # the mixer's input, once
            if cfg.is_attn_layer(i) and cfg.attention != "mla":
                qo = T * cfg.num_heads * cfg.hd * act
                if sharded(pre + "attn.wq"):
                    add("all-to-all", qo // m, uses)              # heads -> seq site
                kv = B * S * cfg.num_kv_heads * cfg.hd * act
                add("all-gather", kv, uses * (1 + sharded(pre + "attn.wv")))   # k (, v)
                add("all-to-all" if sharded(pre + "attn.wo") else "all-gather",
                    qo // (m if sharded(pre + "attn.wo") else 1), uses)   # seq -> wo
            if cfg.is_moe_layer(i):
                add("all-gather", T * d * act, uses)              # the tokens' groups
                add("reduce-scatter", T * d * act // m, uses)     # the partial output
                if cfg.n_shared_experts:
                    mlp(pre + "ffn.shared.", cfg.n_shared_experts
                        * (cfg.moe_d_ff or cfg.d_ff))
            elif cfg.d_ff:
                mlp(pre + "ffn.", cfg.d_ff)
    if cfg.n_experts and E_l < cfg.n_experts:
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        add("all-to-all", G * E_l * cap * d * act, 2 * uses * n_moe)
    kv_seq = rules.get("kv_seq")
    if (kind == "decode" and kv_seq in split and cfg.attention != "mla"
            and _slots(cfg, shape.seq_len) % sizes[kv_seq] == 0):
        H = cfg.num_heads
        n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
        add("all-gather", B * H * cfg.hd * act, n_attn)
        add("all-reduce", B * H * (cfg.hd + 2) * 4, n_attn)
    return {**out, "counts": counts}


def cell_memory(cfg, shape, mesh, rules) -> dict:
    """One card's argument, alias and output bytes from the placements."""
    B, S = shape.global_batch, shape.seq_len
    params = _shard_bytes(_param_leaves(cfg).values(), mesh, rules, cfg.fsdp)
    bsh = _batch_sharding(mesh, B, rules)
    logits = _shard_bytes([((B, cfg.padded_vocab), "float32", ("batch", "vocab"))],
                          mesh, rules)
    if shape.kind == "train":
        p_specs = reference_specs(cfg)
        o_specs = opt_specs(p_specs, opt_config_for(cfg))
        p_sh = tree_shardings(p_specs, mesh, rules, cfg.fsdp)
        o_sh = opt_shardings(o_specs, p_sh, mesh, p_specs, rules, cfg.fsdp)
        opt = _nbytes((), "int32") + sum(
            _nbytes(o_sh[k][p].shard_shape(s), dt)
            for k in o_specs if k != "step" for p, (s, dt, _) in o_specs[k].items())
        structs, b_sh = batch_specs(cfg, shape, mesh, rules)
        batch = sum(_nbytes(b_sh[k].shard_shape(s), dt) for k, (s, dt) in structs.items())
        alias = params + opt
        return {"argument": alias + batch, "alias": alias, "output": alias + 6 * 4}
    cache = _shard_bytes(_spec_leaves(cache_specs(cfg, B, S), cache_axes(cfg, B, S)),
                         mesh, rules)
    extras = _extras_structs(cfg, B, mesh, bsh)
    if shape.kind == "prefill":
        tokens = _nbytes(bsh.shard_shape((B, S)), "int32")
        if extras:
            tokens += sum(_nbytes(extras[1][k].shard_shape(s), dt)
                          for k, (s, dt) in extras[0].items())
        return {"argument": params + tokens, "alias": 0, "output": logits + cache}
    token = _nbytes(bsh.shard_shape((B, 1)), "int32")
    return {"argument": params + token + cache, "alias": cache,
            "output": logits + cache}


def mesh_name_of(mesh) -> str:
    return "x".join(str(s) for s in mesh_axes(mesh).values())


def measure_cell(cfg, shape, mesh, rules, tcfg: TrainConfig | None = None,
                 probe: bool = True, arch: str | None = None) -> dict:
    """The record's measured part for ``cfg`` on ``shape``: ``memory``,
    ``roofline`` (a :class:`~repro_torch.roofline.analysis.Roofline`),
    ``cost_source`` and ``trace_s``."""
    sizes = mesh_axes(mesh)
    chips = math.prod(sizes.values())
    t0 = time.perf_counter()
    with axis_env(mesh, rules):
        probed = _probe_costs(cfg, shape, mesh, rules, tcfg) if probe else None
        cost = probed or trace_step(cfg, shape, mesh, rules, tcfg)
    trace_s = time.perf_counter() - t0
    mem = cell_memory(cfg, shape, mesh, rules)
    roof = analyze(arch or cfg.name, shape.name, mesh_name_of(mesh), chips, cost,
                   count_collectives(cfg, shape, mesh, rules, tcfg),
                   model_flops_for(cfg, shape))
    temp = int(cost["temp_bytes"])
    memory = {
        "argument_bytes": mem["argument"] * chips,
        "output_bytes": mem["output"] * chips,
        "temp_bytes": temp * chips,
        "alias_bytes": mem["alias"] * chips,
        "temp_bytes_per_device": temp,
        "argument_bytes_per_device": mem["argument"],
    }
    return {"memory": memory, "roofline": roof,
            "cost_source": "probe-extrapolated" if probed else "exact",
            "trace_s": trace_s}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             rules_override: dict | None = None, tag: str = "",
             probe: bool = True, cfg_override: dict | None = None,
             tcfg: TrainConfig | None = None, mesh=None) -> dict:
    """One cell's record, written to ``out_dir``.  ``mesh`` replaces the
    production mesh (a ``DeviceMesh`` or a :class:`MeshShape`)."""
    cfg = get_config(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh_name_of(mesh)
    chips = math.prod(mesh_axes(mesh).values())
    rules = make_rules(cfg, **(rules_override or {}))
    if shape_name == "long_500k":
        # context-parallel decode: KV/cache sequence sharded over model axis
        rules["kv_seq"] = "model"

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "kind": shape.kind, "tag": tag, "ok": False,
    }
    try:
        got = measure_cell(cfg, shape, mesh, rules, tcfg, probe, arch=arch)
        rec.update(ok=True, cost_source=got["cost_source"],
                   trace_s=round(got["trace_s"], 2), memory=got["memory"],
                   roofline=got["roofline"].to_dict())
    except Exception as e:  # noqa: BLE001 — a failing cell is a report, not a crash
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}_{shape_name}_{mesh_name}{('_' + tag) if tag else ''}.json"
    with open(out_dir / name, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec["ok"] else "FAIL"
    extra = (f" trace={rec.get('trace_s')}s dominant={rec['roofline']['dominant']}"
             if rec["ok"] else f" {rec.get('error', '')[:120]}")
    print(f"[{status}] {arch} {shape_name} {mesh_name}{extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="all, or archs joined by commas")
    ap.add_argument("--shape", default="all", help="all, or shapes joined by commas")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    out = Path(args.out)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    built = {mp: make_production_mesh(multi_pod=mp) for mp in meshes}
    results = []
    for arch in archs:
        cells = shape_cells(arch) if args.shape == "all" else args.shape.split(",")
        for shape_name in cells:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                f = out / f"{arch}_{shape_name}_{mesh_name}.json"
                if args.skip_existing and f.exists():
                    rec = json.loads(f.read_text())
                    if rec.get("ok"):
                        print(f"[SKIP] {arch} {shape_name} {mesh_name}")
                        results.append(rec)
                        continue
                results.append(run_cell(arch, shape_name, mp, out, mesh=built[mp]))
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK")
    if n_ok < len(results):
        raise SystemExit(1)


__all__ = ["batch_specs", "cell_memory", "count_collectives",
           "count_ops", "measure_cell", "opt_config_for", "opt_shardings", "opt_specs",
           "reference_specs", "run_cell", "trace_step", "main"]


if __name__ == "__main__":
    main()
