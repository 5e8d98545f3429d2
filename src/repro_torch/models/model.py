"""Config-driven model assembly for every LM family of the JAX package
(dense, moe, vlm, audio, hybrid, ssm): parameter specs, the seeded init,
and the reference's entry points ``forward_train``, ``forward_prefill``
and ``forward_decode``.

The model is an :class:`LM` module on an explicit device; it holds the
parameters, and the entry points take it where the JAX package's take its
parameter tree.  Layers run in order from a ``ModuleList``: the JAX
package's scan over periodic layer groups is a compile device of XLA, and
:mod:`repro_torch.convert` alone reads that package's stacked parameter
layout.

Block layout per layer i: norm1 -> mixer: attention (full, sliding
window, or MLA) if ``cfg.is_attn_layer(i)``, else the Mamba-2 block ->
[whisper: norm_x -> cross-attention] -> norm2 -> MoE if
``cfg.is_moe_layer(i)`` else MLP (absent when ``d_ff`` is 0), each with a
residual.  MoE layers add their aux loss along the layers.  Whisper adds
an encoder stack over caller-supplied frame embeddings; the vision stub
projects caller-supplied patch embeddings over the first positions of a
full-sequence pass.  Each layer has its own cache: keys and values (or
MLA's latents) for attention, the float32 state and the conv history for
Mamba-2.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..device import resolve_device
from ..distributed.sharding import distribute, is_dtensor, replicated
from ..distributed.sharding import logical_constraint as lc
from . import layers as L

__all__ = [
    "LM", "param_specs", "param_axes", "init_params",
    "forward_train", "forward_prefill", "forward_decode", "cache_specs",
    "cache_axes", "lm_head_of",
]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _layer_specs(cfg, i: int) -> dict:
    p = {"norm1": L.norm_specs(cfg, cfg.d_model)}
    if cfg.is_attn_layer(i):
        p["attn"] = L.mla_specs(cfg) if cfg.attention == "mla" else L.attention_specs(cfg)
    else:
        p["mamba"] = L.mamba2_specs(cfg)
    if cfg.encoder_layers:
        p["norm_x"] = L.norm_specs(cfg, cfg.d_model)
        p["cross"] = L.cross_attention_specs(cfg)
    if cfg.d_ff or cfg.is_moe_layer(i):
        p["norm2"] = L.norm_specs(cfg, cfg.d_model)
        p["ffn"] = L.moe_specs(cfg) if cfg.is_moe_layer(i) else L.mlp_specs(cfg)
    return p


def _encoder_layer_specs(cfg) -> dict:
    d = cfg.d_model
    return {"norm1": L.norm_specs(cfg, d), "attn": L.attention_specs(cfg),
            "norm2": L.norm_specs(cfg, d), "ffn": L.mlp_specs(cfg)}


def _param_leaves(cfg) -> dict:
    """``{name: (shape, dtype, axes)}`` in the order and with the names of
    ``LM(cfg).named_parameters()``; nothing is allocated."""
    V, d, dt = cfg.padded_vocab, cfg.d_model, cfg.dtype
    out = {"embed": ((V, d), dt, ("vocab", None))}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, V), dt, (None, "vocab"))
    if cfg.frontend == "vision_stub":
        out["patch_proj"] = ((d, d), dt, (None, None))

    def add(prefix, specs):
        for name, leaf in specs.items():
            if isinstance(leaf, dict):
                add(f"{prefix}{name}.", leaf)
            else:
                out[prefix + name] = leaf

    for i in range(cfg.num_layers):
        add(f"layers.{i}.", _layer_specs(cfg, i))
    add("final_norm.", L.norm_specs(cfg, d))
    if cfg.encoder_layers:
        for j in range(cfg.encoder_layers):
            add(f"encoder.layers.{j}.", _encoder_layer_specs(cfg))
        add("encoder.final_norm.", L.norm_specs(cfg, d))
    return out


def param_specs(cfg) -> dict:
    """``{name: (shape, dtype)}`` in the order and with the names of
    ``LM(cfg).named_parameters()``; nothing is allocated."""
    return {name: (shape, dt) for name, (shape, dt, _) in _param_leaves(cfg).items()}


def param_axes(cfg) -> dict:
    """``{name: logical axes}`` of :func:`param_specs`' leaves, the
    reference's names per dimension (its stacked leaves' leading ``None``
    dropped: the port stacks no layers)."""
    return {name: axes for name, (_, _, axes) in _param_leaves(cfg).items()}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _param(shape, dtype: str, device) -> nn.Parameter:
    # serving records no gradients: a trainer turns them on
    # (``model.requires_grad_(True)``) on the model it trains
    return nn.Parameter(torch.empty(shape, dtype=L.torch_dtype(dtype),
                                    device=device), requires_grad=False)


class Block(nn.Module):
    """Decoder layer ``i``: returns (x, aux), aux the MoE layer's loss or
    None.  Its mixer is ``attn`` or ``mamba``; a Mamba layer reads no
    rotary, mask or index."""

    def __init__(self, cfg, i: int, device):
        super().__init__()
        self.norm1 = L.Norm(cfg, cfg.d_model, device)
        if cfg.is_attn_layer(i):
            self.attn = (L.MLAttention(cfg, device) if cfg.attention == "mla"
                         else L.Attention(cfg, device))
        else:
            self.mamba = L.Mamba2(cfg, device)
        if cfg.encoder_layers:
            self.norm_x = L.Norm(cfg, cfg.d_model, device)
            self.cross = L.CrossAttention(cfg, device)
        self.moe = cfg.is_moe_layer(i)
        if cfg.d_ff or self.moe:
            self.norm2 = L.Norm(cfg, cfg.d_model, device)
            self.ffn = L.MoE(cfg, device) if self.moe else L.MLP(cfg, device)

    def forward(self, x, rope, mask, *, mode, cache=None, index=0, enc_kv=None):
        if hasattr(self, "mamba"):
            x = x + self.mamba(self.norm1(x), cache=cache,
                               mode="decode" if mode == "decode" else "causal")
        else:
            x = x + self.attn(self.norm1(x), rope, mask, mode=mode, cache=cache,
                              index=index)
        if enc_kv is not None and hasattr(self, "cross"):
            x = x + self.cross(self.norm_x(x), enc_kv)
        aux = None
        if self.moe:
            f, aux = self.ffn(self.norm2(x))
            x = x + f
        elif hasattr(self, "ffn"):
            x = x + self.ffn(self.norm2(x))
        return lc(x, "batch", "seq", None), aux


class EncoderBlock(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.norm1 = L.Norm(cfg, cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.norm2 = L.Norm(cfg, cfg.d_model, device)
        self.ffn = L.MLP(cfg, device)

    def forward(self, x):
        # placed as the residual stream, as a decoder layer's output is: in
        # the backward the gradient comes back to each layer whole
        x = x + self.attn(self.norm1(x), None, None, mode="bidir")
        return lc(x + self.ffn(self.norm2(x)), "batch", "seq", None)


class Encoder(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.layers = nn.ModuleList(EncoderBlock(cfg, device)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = L.Norm(cfg, cfg.d_model, device)


class LM(nn.Module):
    """The parameters of one config on one device, uninitialised (fill them
    with :func:`init_params` or :func:`repro_torch.convert.lm_params_from_arrays`).
    ``device=None`` is the card and raises without one; ``"cpu"`` runs
    here; ``"meta"`` allocates nothing (shapes alone)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        self.cfg = cfg
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = _param((V, d), cfg.dtype, dev)
        self.layers = nn.ModuleList(Block(cfg, i, dev) for i in range(cfg.num_layers))
        self.final_norm = L.Norm(cfg, d, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((d, V), cfg.dtype, dev)
        if cfg.encoder_layers:
            self.encoder = Encoder(cfg, dev)
        if cfg.frontend == "vision_stub":
            self.patch_proj = _param((d, d), cfg.dtype, dev)
        self.device = self.embed.device


def _init_leaf(name: str, p: torch.Tensor, generator: torch.Generator):
    """Fill ``p`` (a whole leaf) by the init rule of :func:`init_params`."""
    if name.endswith("scale") or name.endswith(".mamba.D"):
        p.fill_(1.0)
    elif name.endswith(".mamba.A_log"):
        p.copy_(torch.log(torch.linspace(1.0, 16.0, p.shape[0],
                                         dtype=torch.float32)))
    elif name.endswith(".mamba.dt_bias"):
        p.fill_(0.5)
    elif p.ndim == 1:
        p.zero_()
    else:
        std = min(0.02, 1.0 / math.sqrt(max(p.shape[-2], 1)))
        w = torch.randn(p.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        p.copy_(w.mul_(std))
        del w          # one float32 leaf alive at a time


def init_params(cfg, generator: torch.Generator, device=None, mesh=None,
                rules=None) -> LM:
    """A model with the reference's init rule (not its bits): ``*scale``
    leaves ones; Mamba-2's ``A_log`` ``log(linspace(1, 16, H))``, ``D``
    ones and ``dt_bias`` 0.5; other 1-D leaves zeros; the others normal
    with std ``min(0.02, 1/sqrt(shape[-2]))``, drawn in float32 from
    ``generator`` (on its own device) in ``named_parameters`` order, then
    cast.

    With a ``mesh`` (a ``DeviceMesh`` of this process's group) and its
    ``rules``, every parameter is a DTensor placed by
    :func:`repro_torch.distributed.param_shardings`: every rank draws each
    whole leaf in turn from the same seeded generator, as one process
    does, and keeps its block, so the values are the one-process init's
    bit for bit and one whole leaf at a time is the memory it takes
    beyond the blocks."""
    if mesh is None:
        model = LM(cfg, device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                _init_leaf(name, p, generator)
        return model
    from ..distributed.sharding import _owner, distribute, param_shardings

    dev = resolve_device(device)
    model = LM(cfg, "meta")
    shardings = param_shardings(cfg, mesh, rules)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            full = torch.empty(p.shape, dtype=p.dtype, device=dev)
            _init_leaf(name, full, generator)
            owner, leaf = _owner(model, name)
            setattr(owner, leaf, nn.Parameter(
                distribute(full, mesh, shardings[name].placements),
                requires_grad=False))
            del full
    model.device = dev
    return model


# ---------------------------------------------------------------------------
# embedding / frontends
# ---------------------------------------------------------------------------

def _check(model: LM, cfg):
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name}, not for "
                         f"the config passed ({cfg.name})")


def _tokens(model: LM, tokens) -> torch.Tensor:
    if is_dtensor(tokens):
        return tokens.long()
    return torch.as_tensor(tokens, device=model.device).long()


def _extra(model: LM, extras, key):
    if not extras or key not in extras:
        return None
    if is_dtensor(extras[key]):
        return extras[key]
    return torch.as_tensor(extras[key], device=model.device)


def _sinusoidal(positions, d, dtype):
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _embed_on_mesh(tokens, table):
    """The embedding on a mesh: each rank looks up its batch block's tokens
    in its block of the vocabulary, zeros for the others', a partial sum
    over the axes that split the vocabulary (DTensor's own rule for a
    sharded table returns a partial type its backward cannot convert)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..distributed.sharding import env_placements, local_fallback

    mesh = table.device_mesh
    vocab = env_placements(("vocab", None), table.shape)
    tok = env_placements(("batch", None), tokens.shape)
    split = [i for i, p in enumerate(vocab) if isinstance(p, Shard)]
    block = 0
    for i in split:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    rows = table.shape[0] // math.prod(mesh.size(i) for i in split)
    out = tuple(Partial() if i in split else tok[i] for i in range(mesh.ndim))
    grad = tuple(vocab[i] if i in split else
                 Partial() if isinstance(tok[i], Shard) else Replicate()
                 for i in range(mesh.ndim))

    def lookup(tokens, table):
        local = tokens - block * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(torch.where(inside, local, 0), table)
        return x * inside[..., None].to(x.dtype)

    return local_fallback(lookup, (tokens, table), (tok, vocab), out, (tok, grad))


def _embed(model: LM, tokens, cfg, extras) -> torch.Tensor:
    # F.embedding's backward sums the rows of repeated tokens in a fixed
    # order on the card; indexing's would add them atomically
    x = (_embed_on_mesh(tokens, model.embed) if is_dtensor(model.embed)
         else F.embedding(tokens, model.embed))
    x = lc(x, "batch", "seq", None)
    pe = _extra(model, extras, "patch_embeds")
    # the patch prefix applies to full-sequence passes, never decode steps
    if cfg.frontend == "vision_stub" and pe is not None and x.shape[1] > 1:
        pe = pe.to(x.dtype) @ model.patch_proj
        x = pe[:, :x.shape[1]] if pe.shape[1] >= x.shape[1] else _splice(x, pe)
    return lc(x, "batch", "seq", None)


def _splice(x, pe):
    """x (B, S, d) with its first n positions taken from pe (B, n, d), n <
    S.  On a mesh each rank writes the prefix rows that its block of the
    sequence holds (x placed as the residual stream, pe whole along its
    rows), wherever the prefix ends; pe's gradient is a partial sum over
    the axes that split the sequence."""
    n = pe.shape[1]
    if not is_dtensor(x):
        return torch.cat([pe, x[:, n:]], 1)
    from torch.distributed.tensor import Partial, Replicate

    from ..distributed.sharding import env_placements, local_fallback, local_rows

    xp = env_placements(("batch", "seq", None), x.shape)
    pp = tuple(p if p.is_shard(0) else Replicate() for p in xp)
    grad = tuple(Partial() if p.is_shard(1) else q for p, q in zip(xp, pp))
    S = x.shape[1]
    off, rows = local_rows(xp, x.device_mesh, S)

    def splice(x, pe):
        # the same ops and shapes on every rank (only the offset differs),
        # so that every rank's backward runs its collectives in one order
        B, _, d = pe.shape
        full = torch.cat([pe, pe.new_zeros(B, S - n, d)], 1)[:, off:off + rows]
        take = torch.arange(off, off + rows, device=x.device)[:, None] < n
        return torch.where(take, full, x)

    return local_fallback(splice, (x, pe), (xp, pp), xp, (xp, grad))


def _encode(model: LM, frames, cfg) -> torch.Tensor:
    """Whisper encoder over caller-supplied frame embeddings (conv stub)."""
    B, S, _ = frames.shape
    pos = torch.arange(S, device=frames.device)[None].expand(B, S)
    x = frames.to(torch.bfloat16) if cfg.dtype == "bfloat16" else frames
    x = x + _sinusoidal(pos, cfg.d_model, x.dtype)
    for layer in model.encoder.layers:
        x = layer(x)
    return model.encoder.final_norm(x)


def _prepare_encdec(model: LM, positions, x, cfg, extras):
    if not cfg.encoder_layers:
        return x, None
    x = x + _sinusoidal(positions, cfg.d_model, x.dtype)
    enc_out = _encode(model, _extra(model, extras, "frames"), cfg)
    return x, [layer.cross.encode_cross_kv(enc_out) for layer in model.layers]


def _rope(cfg, positions, dtype):
    """(cos, sin) over the rotated width: MLA rotates its
    ``qk_rope_head_dim`` slice whole, the other attentions ``rotary_pct``
    of ``hd``."""
    if cfg.attention == "mla":
        rd = cfg.qk_rope_head_dim
    else:
        rd = int(cfg.rotary_pct * cfg.hd) if cfg.rotary_pct < 1.0 else cfg.hd
    return L.rotary_cos_sin(positions, cfg.rope_theta, rd, dtype) if rd else None


def _window(cfg) -> int:
    return cfg.window if cfg.attention == "swa" else 0


def _attn_layers(cfg) -> list[int]:
    return [i for i in range(cfg.num_layers) if cfg.is_attn_layer(i)]


def lm_head_of(model: LM, cfg):
    return model.embed.T if cfg.tie_embeddings else model.lm_head


def _logits(model: LM, x, cfg):
    x = model.final_norm(x)
    head = lm_head_of(model, cfg)
    if is_dtensor(x) and any(p.is_shard(1) for p in x.placements):
        return _rows_times_head(x, head).float()
    return (x @ head).float()


def _rows_times_head(x, head):
    """``x @ head`` on a mesh for x (B, S, d) whose sequence is sharded:
    each rank multiplies its block of (batch, seq) by the head gathered
    whole, so neither the hidden states (B, S, d) nor the logits (B, S, V)
    move between ranks (DTensor's product would gather the sequence and
    then move the logits to the sequence's split).  The result is placed
    as x's rows, its vocabulary whole; the head's gradient is a partial
    sum over the axes that split the rows."""
    from torch.distributed.tensor import Partial, Replicate

    from ..distributed.sharding import env_placements, local_fallback

    xp = env_placements(("batch", "seq", None), x.shape)
    rep = tuple(Replicate() for _ in xp)
    summed = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    return local_fallback(torch.matmul, (x, head), (xp, rep), xp, (xp, summed))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

# the products a "dots" layer keeps for the backward: plain matmuls, the
# reference's dots without batch dimensions (a batched product, the
# attention's and the experts', is recomputed)
_DOTS = [torch.ops.aten.mm.default]


def _remat(model: LM, cfg):
    """How a training pass runs a layer, as the reference's ``_remat_wrap``:
    while gradients are recorded for the model's parameters and
    ``cfg.remat`` is on, through ``torch.utils.checkpoint`` (``"full"``:
    nothing of the layer kept, all recomputed in the backward; ``"dots"``:
    the matmul outputs kept, the rest recomputed); else None (called
    directly)."""
    if not (cfg.remat and torch.is_grad_enabled()
            and any(p.requires_grad for p in model.parameters())):
        return None
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _DOTS)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return functools.partial(checkpoint, use_reentrant=False, **kw)


def _causal_pass(model: LM, tokens, cfg, extras, caches):
    B, S = tokens.shape
    positions = torch.arange(S, device=model.device)[None].expand(B, S)
    x = _embed(model, tokens, cfg, extras)
    x, enc_kv = _prepare_encdec(model, positions, x, cfg, extras)
    rope = mask = None
    if _attn_layers(cfg):
        rope = _rope(cfg, positions, x.dtype)
        mask = L.causal_mask(S, _window(cfg), model.device)
        if is_dtensor(x) and rope is not None:
            # replicated DTensors: a remat layer's recomputed forward runs on
            # the backward's thread, where plain tensors do not count as
            # replicated
            rope = tuple(distribute(t, x.device_mesh, replicated(x.device_mesh).placements)
                         for t in rope)
    aux = torch.zeros((), dtype=torch.float32, device=model.device)
    remat = _remat(model, cfg) if caches is None else None
    for i, layer in enumerate(model.layers):
        kw = dict(mode="causal", cache=caches[i] if caches else None,
                  enc_kv=enc_kv[i] if enc_kv else None)
        x, a = (remat(layer, x, rope, mask, **kw) if remat
                else layer(x, rope, mask, **kw))
        if a is not None:
            aux = aux + a
    return x, enc_kv, aux


def forward_train(model: LM, tokens, cfg, extras: Optional[dict] = None,
                  return_hidden: bool = False):
    """tokens (B, S) -> (logits (B, S, V) float32, aux), or with
    ``return_hidden`` the final-normed hidden states (B, S, d) in place of
    the logits (the loss's chunked head reads them).  ``aux`` is the MoE
    auxiliary loss summed over the MoE layers (0 without experts).
    Autograd records the pass for the parameters that require gradients
    (a trainer calls ``model.requires_grad_(True)``; the model is built
    without), each layer recomputed in the backward as ``cfg.remat`` and
    ``cfg.remat_policy`` say."""
    _check(model, cfg)
    tokens = _tokens(model, tokens)
    x, _, aux = _causal_pass(model, tokens, cfg, extras, None)
    if return_hidden:
        return model.final_norm(x), aux
    return lc(_logits(model, x, cfg), "batch", "seq", "vocab"), aux


def _cache_leaves(cfg, i: int, B: int, slots: int) -> dict:
    """Layer ``i``'s cache buffers ``{name: (shape, dtype, axes)}``: the
    latent ``ckv`` and ``krope`` under MLA, else ``k`` and ``v`` (B,
    slots, KV, hd); a Mamba-2 layer's float32 state ``h`` (B, H, P, N) and
    conv history ``conv`` (B, K - 1, conv_dim), whatever ``slots``."""
    dt = cfg.dtype
    if not cfg.is_attn_layer(i):
        di = cfg.ssm_expand * cfg.d_model
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        return {"h": ((B, di // P, P, N), "float32", ("batch", "heads", None, None)),
                "conv": ((B, cfg.ssm_conv - 1, di + 2 * N), dt, ("batch", None, "ffn"))}
    if cfg.attention == "mla":
        lat = ("batch", "kv_seq", None)
        return {"ckv": ((B, slots, cfg.kv_lora_rank), dt, lat),
                "krope": ((B, slots, cfg.qk_rope_head_dim), dt, lat)}
    kv = ((B, slots, cfg.num_kv_heads, cfg.hd), dt,
          ("batch", "kv_seq", "kv_heads", None))
    return {"k": kv, "v": kv}


def _new_cache(cfg, B: int, slots: int, device) -> list[dict]:
    """Zeroed buffers a layer (a prefill's initial state)."""
    return [{name: torch.zeros(shape, dtype=L.torch_dtype(dt), device=device)
             for name, (shape, dt, _) in _cache_leaves(cfg, i, B, slots).items()}
            for i in range(cfg.num_layers)]


@torch.no_grad()
def forward_prefill(model: LM, tokens, cfg, extras: Optional[dict] = None,
                    max_len: Optional[int] = None):
    """Returns (last-token logits (B, V) float32, cache).  An attention
    layer's cache holds ``max(S, max_len)`` slots, or the ``window`` slots
    of the rolling buffer under SWA; ``{"layers": [{"k", "v"}, {"ckv",
    "krope"} or {"h", "conv"}], "enc_kv", "pos"}``."""
    _check(model, cfg)
    tokens = _tokens(model, tokens)
    B, S = tokens.shape
    window = _window(cfg)
    slots = window if window else max(S, max_len or S)
    caches = _new_cache(cfg, B, slots, model.device)
    x, enc_kv, _ = _causal_pass(model, tokens, cfg, extras, caches)
    logits = _logits(model, x[:, -1:], cfg)[:, 0]
    return logits, {"layers": caches, "enc_kv": enc_kv, "pos": S}


@torch.no_grad()
def forward_decode(model: LM, token, cache, cfg, extras: Optional[dict] = None):
    """token (B, 1) + cache -> (logits (B, V) float32, new cache): one
    decode step.  The step's keys and values (or Mamba states) are written
    into the cache's buffers in place (the returned cache shares them, with
    ``pos`` + 1), so the cache passed in is spent.  A full (non-SWA)
    attention cache raises; a model without attention layers decodes with
    no position limit."""
    _check(model, cfg)
    token = _tokens(model, token)
    B = token.shape[0]
    idx = int(cache["pos"])
    layers = cache["layers"]
    positions = torch.full((B, 1), idx, device=model.device)
    x = _embed(model, token, cfg, extras)
    if cfg.encoder_layers:
        x = x + _sinusoidal(positions, cfg.d_model, x.dtype)
    rope = mask = None
    attn = _attn_layers(cfg)
    if attn:
        slots = next(iter(layers[attn[0]].values())).shape[1]
        if not _window(cfg) and idx >= slots:
            raise IndexError(f"the cache holds {slots} positions; position {idx} "
                             f"does not fit (pass a larger max_len to prefill)")
        rope = _rope(cfg, positions, x.dtype)
        mask = L.decode_mask(slots, idx, _window(cfg), model.device)
    enc_kv = cache.get("enc_kv")
    for i, layer in enumerate(model.layers):
        x, _ = layer(x, rope, mask, mode="decode", cache=layers[i], index=idx,
                     enc_kv=enc_kv[i] if enc_kv else None)
    logits = _logits(model, x, cfg)[:, 0]
    return logits, {"layers": layers, "enc_kv": enc_kv, "pos": idx + 1}


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def _cache_tree(cfg, batch: int, seq_len: int, part) -> dict:
    """The cache's tree with ``leaf[part]`` of each ``(shape, dtype, axes)``
    leaf: ``slice(0, 2)`` for the specs, ``2`` for the axes."""
    S = min(seq_len, cfg.window) if cfg.attention == "swa" else seq_len
    out = {"layers": [{name: leaf[part] for name, leaf
                       in _cache_leaves(cfg, i, batch, S).items()}
                      for i in range(cfg.num_layers)],
           "pos": ((), "int32", ())[part]}
    enc = ((batch, cfg.encoder_seq, cfg.num_heads, cfg.hd), cfg.dtype,
           ("batch", None, "heads", None))[part]
    out["enc_kv"] = ([(enc, enc) for _ in range(cfg.num_layers)]
                     if cfg.encoder_layers else None)
    return out


def cache_specs(cfg, batch: int, seq_len: int) -> dict:
    """Spec tree of a cache holding ``seq_len`` tokens, in the port's cache
    layout: ``{"layers": [{"k", "v"}, {"ckv", "krope"} or {"h", "conv"}],
    "pos", "enc_kv"}``, leaves ``(shape, dtype)``; the reference's
    per-layer fields unstacked, its ``index`` kept once as ``pos``."""
    return _cache_tree(cfg, batch, seq_len, slice(0, 2))


def cache_axes(cfg, batch: int, seq_len: int) -> dict:
    """:func:`cache_specs`' tree with each leaf's logical axes in place of
    ``(shape, dtype)``: the reference's ``_layer_cache_specs`` names."""
    return _cache_tree(cfg, batch, seq_len, 2)
