"""Model layers of the LM families in plain PyTorch: norms, rotary, GQA /
sliding-window attention with a KV cache, cross-attention, the four MLPs,
DeepSeek-V2's multi-head latent attention (MLA) with its compressed cache,
the sort-based capacity-dispatch MoE, and the Mamba-2 (SSD) block with its
recurrent state cache.

Conventions, as in the JAX package's layers:

* Each layer has a ``*_specs`` builder returning ``{name: (shape, dtype,
  axes)}`` for its parameters, ``axes`` the reference's logical name per
  dimension (:mod:`repro_torch.distributed.sharding` resolves them); the
  modules allocate from those specs, so the specs (and
  ``ModelConfig.param_count``) are the modules' parameters without any
  allocation.
* Compute dtype follows the input; norms and softmax run in float32 and
  cast back.  The norm parameters stay float32 while the weights are
  ``cfg.dtype``, so every mixed product is cast explicitly (PyTorch would
  promote bfloat16 x float32 to float32).
* The products the reference writes as einsums are ``matmul``/``einsum``
  here: no fused attention kernel stands in for them.
* Activations take the reference's ``logical_constraint`` names at its
  sites (no-ops off a mesh).  On a mesh of DTensors three parts run on
  local tensors: the attention cores (each rank its block of the
  queries: (batch, seq) where the rules shard the sequence, the keys and
  values gathered and the mask cut to the rank's rows, else (batch,
  heads)), the MoE dispatch, whose sort, scatter and gathers have no
  DTensor sharding rule (each rank its groups and its experts), and the
  Mamba-2 block (each rank its batch rows' whole sequence, the leaves
  gathered).  Where the rules shard the sequence, each branch's input is
  gathered (or split along its width) before its products and its output
  placed back on the sequence's split explicitly (``_seq_for``,
  ``_rows``): PyTorch 2.11's DTensor flattens no sharded sequence.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import env_placements, is_dtensor, local_fallback, \
    local_rows
from ..distributed.sharding import logical_constraint as lc

__all__ = [
    "Norm", "Attention", "CrossAttention", "MLP", "MLAttention", "MoE",
    "norm_specs", "attention_specs", "cross_attention_specs", "mlp_specs",
    "mla_specs", "moe_specs", "moe_capacity", "moe_one_group",
    "Mamba2", "mamba2_specs", "ssd_chunked", "chunk_states", "ssd_step",
    "apply_norm", "rotary_cos_sin", "rotate", "sdpa",
    "causal_mask", "decode_mask", "torch_dtype",
]

Specs = dict  # {name: (shape, dtype name, logical axes)}


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class _Leaves(nn.Module):
    """A module whose parameters are the leaves of one spec dict, allocated
    uninitialised on ``device`` (``init_params`` or ``convert`` fills them).
    Serving needs no gradients, so none are recorded until a trainer calls
    ``requires_grad_(True)``."""

    def __init__(self, specs: Specs, device):
        super().__init__()
        for name, (shape, dtype, _axes) in specs.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=torch_dtype(dtype), device=device),
                requires_grad=False))


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

def norm_specs(cfg, d: int) -> Specs:
    if cfg.norm == "layernorm":
        return {"scale": ((d,), "float32", (None,)),
                "bias": ((d,), "float32", (None,))}
    return {"scale": ((d,), "float32", (None,))}


def apply_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * scale
    return out.to(x.dtype)


class Norm(_Leaves):
    def __init__(self, cfg, d: int, device):
        super().__init__(norm_specs(cfg, d), device)
        self.kind = cfg.norm

    def forward(self, x):
        return apply_norm(x, self.scale, getattr(self, "bias", None), self.kind)


# ---------------------------------------------------------------------------
# rotary position embedding (rotate-half layout, partial rotary)
# ---------------------------------------------------------------------------

def rotary_cos_sin(positions: torch.Tensor, theta: float, rotary_dim: int,
                   dtype: torch.dtype):
    """cos/sin of shape (B, S, 1, rotary_dim // 2): frequencies and angles
    in float32, cast to the activation dtype before the multiply."""
    half = rotary_dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); the first ``2 * cos.shape[-1]`` features rotate."""
    half = cos.shape[-1]
    rd = 2 * half
    x1, x2 = x[..., :half], x[..., half:rd]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot, x[..., rd:]], dim=-1) if rd < x.shape[-1] else rot


# ---------------------------------------------------------------------------
# attention (GQA full / sliding-window) with a KV cache
# ---------------------------------------------------------------------------

def causal_mask(S: int, window: int, device) -> torch.Tensor:
    """(S, S) bool: key j visible from query i (a band under SWA)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    mask = j <= i
    if window:
        mask &= (i - j) < window
    return mask


def decode_mask(slots: int, index: int, window: int, device) -> torch.Tensor:
    """(1, slots) bool: the cache slots filled once position ``index`` is
    written (a rolling buffer under SWA holds the last ``slots``)."""
    filled = min(index + 1, slots) if window else index + 1
    return (torch.arange(slots, device=device) < filled)[None, :]


def _splits(p, dim: int) -> bool:
    from torch.distributed.tensor import Shard

    return isinstance(p, Shard) and p.dim == dim


def _core_placements(q, seq: bool):
    """On a mesh, an attention core's placements: those of the queries and
    the output, (B, S, heads, ...) as ``("batch", "seq", "heads")`` resolve
    (``seq`` False: the sequence whole); of a key or value tensor, (B, S,
    heads, ...) gathered whole along the sequence, and of the gradient
    each rank gives it (a partial sum over the mesh axes that split the
    queries' rows); and of a tensor the heads share, (B, S, ...), with
    its gradient (a partial sum over the mesh axes that split the heads
    or the rows)."""
    from torch.distributed.tensor import Partial, Replicate

    qp = env_placements(("batch", "seq" if seq else None, "heads")
                        + (None,) * (q.ndim - 3), q.shape)
    kv = tuple(Replicate() if _splits(p, 1) else p for p in qp)
    kv_grad = tuple(Partial() if _splits(p, 1) else p for p in qp)
    shared = tuple(p if _splits(p, 0) else Replicate() for p in qp)
    shared_grad = tuple(p if _splits(p, 0) else Partial() if p.is_shard() else Replicate()
                        for p in qp)
    return qp, kv, kv_grad, shared, shared_grad


def _mask_rows(mask, q, qp):
    """The rows of an (Sq, Sk) mask that this rank's block of the queries
    placed as ``qp`` holds (the whole mask when the rows are whole)."""
    if mask is None:
        return None
    off, rows = local_rows(qp, q.device_mesh, q.shape[1])
    return mask[off:off + rows]


def _sdpa_on_mesh(q, k, v, mask, groups: int):
    """:func:`sdpa` on a mesh, on local tensors (the products' batched
    dimensions would be flattened across two sharded axes, which DTensor
    refuses): each rank attends its block of the queries, (batch, seq)
    where the rules shard the sequence (keys and values gathered whole
    along it, the mask cut to the rank's rows, a band's offset with
    them), else (batch, heads); a kv head whose group the heads' split
    cuts is repeated for its group first."""
    qp, kv, kv_grad, _, _ = _core_placements(q, seq=True)
    ways = math.prod(q.device_mesh.size(i) for i, p in enumerate(qp) if _splits(p, 2))
    if groups > 1 and k.shape[2] % ways:
        k, v, groups = k.repeat_interleave(groups, 2), v.repeat_interleave(groups, 2), 1
    rows = _mask_rows(mask, q, qp)
    return local_fallback(lambda q, k, v: sdpa(q, k, v, rows, groups), (q, k, v),
                          (qp, kv, kv), qp, (qp, kv_grad, kv_grad))


def sdpa(q, k, v, mask: Optional[torch.Tensor], groups: int) -> torch.Tensor:
    """q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd), mask (Sq, Sk) or None (all
    visible).  Query head h reads kv head h // groups.  Scores in the input
    dtype scaled there, then float32 for the mask and softmax, and the
    weights cast back to v's dtype."""
    if is_dtensor(q):
        return _sdpa_on_mesh(q, k, v, mask, groups)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, Sq, KV, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) / math.sqrt(hd)
    scores = scores.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def attention_specs(cfg) -> Specs:
    d, H, KV, hd, dt = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.dtype
    h_ax = "model" if cfg.attn_tp else None
    # the reference's test, against its 16-way production model axis
    kv_ax = "model" if (cfg.attn_tp and KV % 16 == 0) else None
    p = {
        "wq": ((d, H, hd), dt, (None, h_ax, None)),
        "wk": ((d, KV, hd), dt, (None, kv_ax, None)),
        "wv": ((d, KV, hd), dt, (None, kv_ax, None)),
        "wo": ((H, hd, d), dt, (h_ax, None, None)),
    }
    if cfg.qkv_bias:
        p["bq"] = ((H, hd), dt, (h_ax, None))
        p["bk"] = ((KV, hd), dt, (kv_ax, None))
        p["bv"] = ((KV, hd), dt, (kv_ax, None))
    return p


def _seq_for(x, w=None):
    """On a mesh, x (B, S, ..., d) with its sequence whole again over each
    mesh axis that shards it, so that a product with ``w`` (d rows)
    flattens no sharded sequence (PyTorch 2.11's DTensor refuses to
    flatten one; 2.13 redistributes on its own, the same way): split
    along d instead where ``w``'s rows shard over that axis (an
    all-to-all), else gathered whole (an all-gather).  Anything else is
    returned as it is."""
    if not is_dtensor(x) or x.ndim < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard

    pl = list(x.placements)
    for i, p in enumerate(x.placements):
        if _splits(p, 1):
            rows = is_dtensor(w) and _splits(w.placements[i], 0)
            pl[i] = Shard(x.ndim - 1) if rows else Replicate()
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def _rows(y):
    """On a mesh, a branch's output (B, S, d) placed explicitly as the
    residual stream's ``("batch", "seq", None)`` resolves (a partial sum
    reduce-scattered onto the sequence's split, as DTensor would do at
    the residual add), so that in the backward its gradient comes back
    whole along the sequence to the product that made it (PyTorch 2.11's
    DTensor cannot flatten a sharded sequence there).  Anything else is
    returned as it is."""
    if not is_dtensor(y):
        return y
    return y.redistribute(y.device_mesh, env_placements(("batch", "seq", None), y.shape))


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk")."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = wo.shape
    wo = wo.reshape(h * k, d)
    return _seq_for(o.flatten(-2), wo) @ wo


class Attention(_Leaves):
    """Self-attention in the reference's four modes: ``"causal"`` (a band
    under SWA; fills ``cache`` when one is given), ``"bidir"`` (encoder: no
    rotary, no mask), ``"decode"`` (one token written into ``cache`` at
    ``index``, or at ``index % window`` under SWA).  ``rope`` is the
    (cos, sin) pair of :func:`rotary_cos_sin` for ``x``'s positions."""

    def __init__(self, cfg, device):
        super().__init__(attention_specs(cfg), device)
        self.groups = cfg.num_heads // cfg.num_kv_heads
        self.window = cfg.window if cfg.attention == "swa" else 0
        self.qkv_bias = cfg.qkv_bias

    def forward(self, x, rope, mask, *, mode: str = "causal",
                cache: Optional[dict] = None, index: int = 0):
        x = _seq_for(x)     # on a mesh: the projections' input, gathered once
        q, k, v = _project(x, self.wq), _project(x, self.wk), _project(x, self.wv)
        if self.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = lc(q, "batch", "seq", "heads", None)
        k = lc(k, "batch", "seq", "kv_heads", None)
        if mode != "bidir" and rope is not None:
            q, k = rotate(q, *rope), rotate(k, *rope)
        if mode == "decode":
            slot = index % self.window if self.window else index
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            out = sdpa(q, cache["k"], cache["v"], mask, self.groups)
        else:
            out = sdpa(q, k, v, mask, self.groups)
            if cache is not None:
                _fill_cache(cache, k, v, self.window)
        return lc(_out(out, self.wo), "batch", "seq", None)


def _fill_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, window: int):
    """Write a prompt's keys and values into preallocated (zeroed) buffers:
    position p at slot p, or at slot p % window in the rolling buffer,
    which keeps the trailing ``window`` positions."""
    S = k.shape[1]
    if window and S > window:
        roll = S % window
        cache["k"].copy_(torch.roll(k[:, S - window:], roll, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - window:], roll, dims=1))
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attention_specs(cfg) -> Specs:
    d, H, hd, dt = cfg.d_model, cfg.num_heads, cfg.hd, cfg.dtype
    h_ax = "model" if cfg.attn_tp else None
    return {
        "wq": ((d, H, hd), dt, (None, h_ax, None)),
        "wk": ((d, H, hd), dt, (None, h_ax, None)),
        "wv": ((d, H, hd), dt, (None, h_ax, None)),
        "wo": ((H, hd, d), dt, (h_ax, None, None)),
    }


class CrossAttention(_Leaves):
    def __init__(self, cfg, device):
        super().__init__(cross_attention_specs(cfg), device)

    def forward(self, x, enc_kv: tuple):
        """enc_kv = (k, v) from :meth:`encode_cross_kv`: (B, Senc, H, hd)."""
        k, v = enc_kv
        out = sdpa(_project(x, self.wq), k, v, None, 1)
        return _out(out, self.wo)

    def encode_cross_kv(self, enc_out):
        return _project(enc_out, self.wk), _project(enc_out, self.wv)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(cfg, d_ff: Optional[int] = None) -> Specs:
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.dtype
    up, down = ((d, f), dt, (None, "ffn")), ((f, d), dt, ("ffn", None))
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": up, "w_up": up, "w_down": down}
    return {"w_up": up, "w_down": down}


class MLP(_Leaves):
    """swiglu / geglu (gated), gelu, relu2 (``relu(x)**2``); gelu is the
    tanh form, the reference's default.  ``d_ff`` overrides the config's
    width (MoE's shared experts)."""

    def __init__(self, cfg, device, d_ff: Optional[int] = None):
        if cfg.act not in ("swiglu", "geglu", "gelu", "relu2"):
            raise ValueError(f"unknown activation {cfg.act!r}")
        super().__init__(mlp_specs(cfg, d_ff), device)
        self.act = cfg.act

    def forward(self, x):
        x = _seq_for(x)     # on a mesh: the up products' input, gathered once
        if self.act in ("swiglu", "geglu"):
            g = x @ self.w_gate
            g = F.silu(g) if self.act == "swiglu" else F.gelu(g, approximate="tanh")
            h = g * (x @ self.w_up)
        else:
            h = x @ self.w_up
            h = F.gelu(h, approximate="tanh") if self.act == "gelu" else F.relu(h) ** 2
        return _rows(_seq_for(lc(h, "batch", "seq", "ffn"), self.w_down) @ self.w_down)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_specs(cfg) -> Specs:
    d, H, dt = cfg.d_model, cfg.num_heads, cfg.dtype
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    return {
        "wq": ((d, H, dn + dr), dt, (None, "model", None)),
        "w_dkv": ((d, r + dr), dt, (None, None)),  # down: c_kv and the shared k_rope
        "w_uk": ((r, H, dn), dt, (None, "model", None)),   # up: k_nope
        "w_uv": ((r, H, dv), dt, (None, "model", None)),   # up: v
        "wo": ((H, dv, d), dt, ("model", None, None)),
        "kv_norm": {"scale": ((r,), "float32", (None,))},
    }


class MLAttention(_Leaves):
    """Multi-head latent attention, ``"causal"`` (fills ``cache`` when one
    is given) or ``"decode"`` (one token written into ``cache`` at
    ``index``).  The cache holds the normed latent ``ckv`` (B, slots, r)
    and the rotated key part ``krope`` (B, slots, dr) that all heads
    share; every call recomputes k_nope and v from the latents over all
    its slots, the reference's memory/compute trade.  ``rope`` is the
    (cos, sin) pair of :func:`rotary_cos_sin` over ``qk_rope_head_dim``."""

    def __init__(self, cfg, device):
        specs = mla_specs(cfg)
        norm = specs.pop("kv_norm")
        super().__init__(specs, device)
        self.kv_norm = _Leaves(norm, device)
        self.r, self.dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
        self.scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)

    def forward(self, x, rope, mask, *, mode: str = "causal",
                cache: Optional[dict] = None, index: int = 0):
        x = _seq_for(x)     # on a mesh: the projections' input, gathered once
        q = _project(x, self.wq)
        q_nope, q_rope = q[..., :self.dn], rotate(q[..., self.dn:], *rope)
        dkv = x @ self.w_dkv
        c_kv = apply_norm(dkv[..., :self.r], self.kv_norm.scale, None, "rmsnorm")
        k_rope = rotate(dkv[..., None, self.r:], *rope)[:, :, 0]
        if mode == "decode":
            cache["ckv"][:, index] = c_kv[:, 0]
            cache["krope"][:, index] = k_rope[:, 0]
            c_kv, k_rope = cache["ckv"], cache["krope"]
        elif cache is not None:
            cache["ckv"][:, :x.shape[1]] = c_kv
            cache["krope"][:, :x.shape[1]] = k_rope
        k_nope, v = _project(c_kv, self.w_uk), _project(c_kv, self.w_uv)
        args = (q_nope, q_rope, k_nope, k_rope, v)

        def core(q_nope, q_rope, k_nope, k_rope, v, mask=mask):
            scores = (torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope)
                      + torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope)) * self.scale
            scores = scores.float().masked_fill(~mask, -1e30)
            w = torch.softmax(scores, dim=-1).to(v.dtype)
            return torch.einsum("bhqs,bshk->bqhk", w, v)

        if is_dtensor(q_nope):
            # no "seq" site here in the reference: q arrives split by heads
            # from its projection, and each rank attends its block of
            # (batch, heads), k_rope gathered whole
            qp, kv, kv_grad, shared, shared_grad = _core_placements(q_nope, seq=False)
            rows = _mask_rows(mask, q_nope, qp)
            out = local_fallback(lambda *a: core(*a, mask=rows), args,
                                 (qp, qp, kv, shared, kv), qp,
                                 (qp, qp, kv_grad, shared_grad, kv_grad))
        else:
            out = core(*args)
        return lc(_out(out, self.wo), "batch", "seq", None)


# ---------------------------------------------------------------------------
# MoE (sort-based capacity dispatch)
# ---------------------------------------------------------------------------

def moe_specs(cfg) -> Specs:
    d, f, E, dt = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts, cfg.dtype
    # the experts shard over the model axis when E divides it, else their
    # ffn width does (one mesh axis per spec)
    up = ((E, d, f), dt, ("experts", None, "expert_ffn"))
    p = {"router": ((d, E), "float32", (None, None)),
         "experts": {"w_gate": up, "w_up": up,
                     "w_down": ((E, f, d), dt, ("experts", "expert_ffn", None))}}
    if cfg.n_shared_experts:
        p["shared"] = mlp_specs(cfg, cfg.n_shared_experts * f)
    return p


def moe_capacity(cfg, N: int) -> tuple[int, int]:
    """(G, cap) for N tokens: ``moe_groups`` local dispatch groups when
    they divide N (else one), and each expert's slots in a group,
    ``max(8, ceil(N/G * K/E * capacity_factor))`` rounded up to 8."""
    G = cfg.moe_groups or 1
    if N % G:
        G = 1
    cap = int(math.ceil(N // G * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return G, max(8, (cap + 7) // 8 * 8)


def moe_one_group(xg, router, w_gate, w_up, w_down, act: str, top_k: int,
                  cap: int, first: int = 0):
    """Sort-based capacity dispatch of G token groups, each routed, sorted
    and dropped on its own (the reference's ``_moe_one_group`` under its
    vmap): xg (G, n, D) -> (out (G, n, D), aux (G,) float32, dropped (G,)
    assignments past their expert's ``cap`` slots).  Weights that hold
    fewer experts than the router routes to are the block from expert
    ``first`` on (a rank's block on a mesh): the other experts' slots
    contribute nothing.

    The router and its softmax run in float32; the top-k gates are
    renormalised.  Assignments are stably sorted by expert; an
    assignment's rank within its expert decides its slot, and one past
    capacity lands on a spare row that is never computed on and reads
    back as zero.  The combine puts the N*K weighted contributions back
    into assignment order and sums each token's K in a fixed order."""
    G, n, D = xg.shape
    E, K = router.shape[1], top_k
    probs = torch.softmax(xg.float() @ router, dim=-1)            # (G, n, E)
    top_p, top_i = torch.topk(probs, K, dim=-1)
    gates = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    eid = top_i.reshape(G, n * K)
    # Switch-style load-balancing loss: counts of whole assignments, exact
    # in float32 whatever the order of the adds
    counts = torch.zeros(G, E, device=xg.device).scatter_add_(
        1, eid, torch.ones(eid.shape, device=xg.device))
    aux = E * (probs.mean(1) * counts / (n * K)).sum(-1)

    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = eid.gather(1, order)
    rank = (torch.arange(n * K, device=xg.device)
            - torch.searchsorted(eid_s, eid_s, side="left"))
    keep = rank < cap
    slot = torch.where(keep, eid_s * cap + rank, E * cap)
    gi = torch.arange(G, device=xg.device)[:, None]
    # kept slots are distinct: the dispatch writes each once
    xe = xg.new_zeros(G, E * cap + 1, D)
    xe[gi, slot] = xg[gi, order // K]
    E_w = w_gate.shape[0]
    xe = xe[:, :E * cap].reshape(G, E, cap, D).transpose(0, 1)
    if E_w < E:
        xe = xe[first:first + E_w]
    xe = xe.reshape(E_w, G * cap, D)
    if act in ("swiglu", "geglu"):
        g = torch.bmm(xe, w_gate)
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * torch.bmm(xe, w_up)
    else:
        h = F.relu(torch.bmm(xe, w_up))
    ye = torch.bmm(h, w_down).reshape(E_w, G, cap, D)
    if E_w < E:
        ye = F.pad(ye, (0, 0, 0, 0, 0, 0, first, E - first - E_w))
    ye = ye.transpose(0, 1)
    ye = torch.cat([ye.reshape(G, E * cap, D), ye.new_zeros(G, 1, D)], 1)
    contrib = ye[gi, slot] * gates.reshape(G, n * K).gather(1, order).to(
        xg.dtype)[..., None]
    per = torch.empty_like(contrib)
    per[gi, order] = contrib
    return per.reshape(G, n, K, D).sum(2), aux, (~keep).sum(-1)


def _moe_on_mesh(dispatch, args):
    """The MoE dispatch on a mesh, on local tensors (its sort, scatter and
    gathers have no DTensor rule): each rank routes its groups over every
    expert and computes the experts (or the expert widths) its block of
    the weights holds, gathered whole over the axes that split the groups
    (ZeRO-3's shards); the output is a partial sum over the axes that
    split the experts, and the aux loss and the drop count come from the
    first rank along them alone."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    xg, router, w_gate = args[0], args[1], args[2]
    mesh = xg.device_mesh
    groups = env_placements(("batch", None, None), xg.shape)
    split = {i for i, p in enumerate(groups) if not isinstance(p, Shard)
             and isinstance(w_gate.placements[i], Shard)}

    def weight(w):
        return tuple(w.placements[i] if i in split else Replicate()
                     for i in range(mesh.ndim))

    def own(p, i):        # an output's placement on mesh dimension i
        return p if isinstance(p, Shard) else Partial() if i in split else Replicate()

    out = tuple(own(p, i) for i, p in enumerate(groups))
    per_group = tuple(own(p if isinstance(p, Shard) else Replicate(), i)
                      for i, p in enumerate(env_placements(("batch",), xg.shape[:1])))
    summed = tuple(Partial() if isinstance(p, Shard) or i in split else Replicate()
                   for i, p in enumerate(groups))
    experts = [i for i in split if w_gate.placements[i].dim == 0]
    block = 0
    for i in experts:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    E_w = router.shape[1] // math.prod(mesh.size(i) for i in experts)
    lead = all(mesh.get_local_rank(i) == 0 for i in split)

    def local(xg, router, w_gate, w_up, w_down):
        out, aux, dropped = dispatch(xg, router, w_gate, w_up, w_down, block * E_w)
        return out, aux * float(lead), dropped * int(lead)

    ws = [weight(w) for w in args[2:]]
    return local_fallback(
        local, args, (groups, weight(router)) + tuple(ws), [out, per_group, per_group],
        (out, summed) + tuple(tuple(Partial() if isinstance(groups[i], Shard) else p
                                    for i, p in enumerate(w)) for w in ws))


class MoE(_Leaves):
    """Routed experts (``experts``: (E, d, f) gate/up, (E, f, d) down) with
    the float32 ``router``, plus ``n_shared_experts`` always-on experts as
    one MLP of width ``n_shared_experts * moe_d_ff`` (``shared``).
    Returns (out, aux); ``dropped`` holds the assignments the last call
    dropped at capacity, summed over its groups (a 0-d device tensor)."""

    def __init__(self, cfg, device):
        specs = moe_specs(cfg)
        experts = specs.pop("experts")
        shared = specs.pop("shared", None)
        super().__init__(specs, device)
        self.experts = _Leaves(experts, device)
        if shared is not None:
            self.shared = MLP(cfg, device, d_ff=cfg.n_shared_experts
                              * (cfg.moe_d_ff or cfg.d_ff))
        self.cfg = cfg
        self.dropped = None

    def forward(self, x):
        B, S, D = x.shape
        G, cap = moe_capacity(self.cfg, B * S)
        e = self.experts
        # on a mesh the groups cut across a sharded sequence: gathered first
        xg = _seq_for(x).reshape(G, B * S // G, D)
        if G > 1:
            xg = lc(xg, "batch", None, None)
        args = (xg, self.router, e.w_gate, e.w_up, e.w_down)

        def dispatch(xg, router, w_gate, w_up, w_down, first=0):
            return moe_one_group(xg, router, w_gate, w_up, w_down,
                                 self.cfg.act, self.cfg.top_k, cap, first)

        if is_dtensor(xg):
            out, aux, dropped = _moe_on_mesh(dispatch, args)
        else:
            out, aux, dropped = dispatch(*args)
        self.dropped = dropped.sum()
        out = _rows(out.reshape(B, S, D))
        if hasattr(self, "shared"):
            out = out + self.shared(x)
        return out, aux.mean()


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

def mamba2_specs(cfg) -> Specs:
    """The reference's leaves; ``out_norm`` comes last, where
    :class:`Mamba2` registers it."""
    d, dt = cfg.d_model, cfg.dtype
    di = cfg.ssm_expand * d
    H, N = di // cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = di + 2 * N
    return {
        "in_proj": ((d, 2 * di + 2 * N + H), dt, (None, "ffn")),
        "conv_w": ((cfg.ssm_conv, conv_dim), dt, (None, "ffn")),
        "conv_b": ((conv_dim,), dt, ("ffn",)),
        "A_log": ((H,), "float32", (None,)),
        "D": ((H,), "float32", (None,)),
        "dt_bias": ((H,), "float32", (None,)),
        "out_proj": ((di, d), dt, ("ffn", None)),
        "out_norm": {"scale": ((di,), "float32", (None,))},
    }


SSD_CHUNK = 128   # the reference's chunk length for the Mamba-2 scan


def chunk_states(sb: torch.Tensor, seg_total: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """The inter-chunk recurrence of :func:`ssd_chunked` in float32:
    sb (B, nc, H, P, N) each chunk's own state, seg_total (B, nc, H) its
    summed log-decay.  Returns (the state before each chunk (B, nc, H, P,
    N), the state after the last); ``h0`` (zeros if None) is the state
    before the first."""
    h = torch.zeros_like(sb[:, 0]) if h0 is None else h0.to(sb.dtype)
    prevs = []
    for c in range(sb.shape[1]):
        prevs.append(h)
        h = h * torch.exp(seg_total[:, c])[:, :, None, None] + sb[:, c]
    return torch.stack(prevs, 1), h


def ssd_chunked(xh, dt_h, A, B_s, C_s, chunk: int, h0=None):
    """The chunked state-space-dual scan of Mamba-2: xh (B, S, H, P)
    inputs, dt_h (B, S, H) positive steps, A (H,) negative, B_s / C_s
    (B, S, N) (one group), h0 an optional initial state (B, H, P, N).
    Returns (y (B, S, H, P), the final state (B, H, P, N)).

    Chunks of ``Q = min(chunk, S)`` positions: within a chunk the
    quadratic (attention-like) form, its decays masked to -inf above the
    diagonal before the ``exp``; across chunks the recurrence of
    :func:`chunk_states` on each chunk's summary state.  ``S`` must be a
    whole number of chunks, as in the reference."""
    Bb, S, H, P = xh.shape
    N = B_s.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"the SSD scan takes whole chunks of {chunk} "
                         f"positions (or fewer than {chunk} in all); {S} "
                         f"positions are not")
    nc = S // Q
    xc = xh.reshape(Bb, nc, Q, H, P)
    dtc = dt_h.reshape(Bb, nc, Q, H)
    Bc = B_s.reshape(Bb, nc, Q, N)
    Cc = C_s.reshape(Bb, nc, Q, N)

    cs = torch.cumsum(dtc * A, dim=2)                      # (B, nc, Q, H)
    seg_total = cs[:, :, -1]                               # (B, nc, H)
    # intra-chunk: the diagonal blocks
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    expo = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (B, nc, Q, Q, H)
    expo = expo.masked_fill(~tri[None, None, :, :, None], -math.inf)
    scores = cb[..., None] * torch.exp(expo) * dtc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", scores, xc)
    # each chunk's summary state, then the recurrence across chunks
    dec_end = torch.exp(seg_total[:, :, None, :] - cs)
    sb = torch.einsum("bcsh,bcsn,bcshp->bchpn", dtc * dec_end, Bc, xc)
    h_prevs, h = chunk_states(sb, seg_total, h0)
    # inter-chunk: what the state before each chunk contributes
    y = y + torch.einsum("bctn,bcth,bchpn->bcthp", Cc, torch.exp(cs), h_prevs)
    return y.reshape(Bb, S, H, P), h


def ssd_step(h, dt, A, B1, C1, x1) -> torch.Tensor:
    """One decode step of the recurrence, in place on the float32 state
    h (B, H, P, N): ``h <- h * exp(dt A) + dt B x^T``; returns ``C h``
    (B, H, P) in float32.  dt (B, H) float32, B1 / C1 (B, N), x1 (B, H, P)."""
    h.mul_(torch.exp(dt * A)[:, :, None, None])
    h.add_(torch.einsum("bh,bn,bhp->bhpn", dt, B1.float(), x1.float()))
    return torch.einsum("bn,bhpn->bhp", C1.float(), h)


def _causal_taps(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of xp (B, S + K - 1, C), left-padded, with
    w (K, C): the K shifted taps summed in order in float32, cast back."""
    K = w.shape[0]
    S = xp.shape[1] - K + 1
    out = xp[:, :S].float() * w[0].float()
    for k in range(1, K):
        out += xp[:, k:k + S].float() * w[k].float()
    return out.to(xp.dtype)


class Mamba2(_Leaves):
    """The Mamba-2 (SSD) block, ``"causal"`` or ``"decode"`` (one token).
    ``cache`` holds the float32 state ``h`` (B, H, P, N) and the conv
    history ``conv`` (B, K - 1, conv_dim); a causal pass starts from its
    ``h`` (zeros from a prefill) and both modes write them in place.

    Casts land where the reference's promotions do: the step sizes, the
    scan and the state in float32; ``y + D x`` in float32, cast to the
    input dtype before the gate and the gated RMSNorm.

    On a mesh (a training pass on DTensors) the block runs on local
    tensors: the reference has no constraint site inside it, and its
    fused ``in_proj`` columns (z | xBC | dt) do not split as the heads
    do.  Each rank takes its batch rows' whole sequence (gathered over
    the axes that split it) and every leaf whole (gathered over the axes
    that shard it: ``model``'s ``ffn`` columns, ZeRO-3's ``data``) and
    runs the one-process block; its output, whole along the sequence,
    is then placed as the residual stream (each rank keeps its rows, and
    the backward gathers the output's gradient whole), so each leaf's
    gradient is a partial sum over the batch's axes alone, the model
    axis' ranks computing the same."""

    def __init__(self, cfg, device):
        specs = mamba2_specs(cfg)
        norm = specs.pop("out_norm")
        super().__init__(specs, device)
        self.out_norm = _Leaves(norm, device)
        self.di = cfg.ssm_expand * cfg.d_model
        self.P, self.N, self.K = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
        self.H = self.di // self.P

    def _leaves(self) -> tuple:
        return (self.in_proj, self.conv_w, self.conv_b, self.A_log, self.D,
                self.dt_bias, self.out_norm.scale, self.out_proj)

    def forward(self, x, *, mode: str = "causal", cache: Optional[dict] = None):
        if is_dtensor(x):
            if mode != "causal" or cache is not None:
                raise NotImplementedError("a Mamba-2 block on a mesh runs causal "
                                          "passes without a cache (training)")
            return self._on_mesh(x)
        return self._block(x, *self._leaves(), mode=mode, cache=cache)

    def _on_mesh(self, x):
        from torch.distributed.tensor import Partial, Replicate

        whole = tuple(p if _splits(p, 0) else Replicate() for p in x.placements)
        leaf_grad = tuple(Partial() if p.is_shard() else Replicate() for p in whole)
        leaves = self._leaves()
        rep = tuple(Replicate() for _ in whole)
        return _rows(local_fallback(self._block, (x, *leaves),
                                    (whole,) + (rep,) * len(leaves), whole,
                                    (whole,) + (leaf_grad,) * len(leaves)))

    def _block(self, x, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_scale,
               out_proj, *, mode: str = "causal", cache: Optional[dict] = None):
        B, S, _ = x.shape
        di, H, P, N, K = self.di, self.H, self.P, self.N, self.K
        z, xbc, dt_raw = (x @ in_proj).split([di, di + 2 * N, H], -1)
        dt_h = F.softplus(dt_raw.float() + dt_bias)               # (B, S, H)
        if mode == "decode":
            hist = torch.cat([cache["conv"], xbc], 1)              # (B, K, conv)
            xbc = _causal_taps(hist, conv_w)
            cache["conv"].copy_(hist[:, 1:])
        else:
            xp = F.pad(xbc, (0, 0, K - 1, 0))
            xbc = _causal_taps(xp, conv_w)
            if cache is not None:   # the last K - 1 inputs, zeros before
                cache["conv"].copy_(xp[:, xp.shape[1] - (K - 1):])
        xs, B_s, C_s = F.silu(xbc + conv_b).split([di, N, N], -1)
        xh = xs.reshape(B, S, H, P)
        A = -torch.exp(A_log)
        if mode == "decode":
            y = ssd_step(cache["h"], dt_h[:, 0], A, B_s[:, 0], C_s[:, 0],
                         xh[:, 0])[:, None]
        else:
            y, h = ssd_chunked(xh.float(), dt_h, A, B_s.float(), C_s.float(),
                               SSD_CHUNK, cache["h"] if cache is not None else None)
            if cache is not None:
                cache["h"].copy_(h)
        y = (y + D[:, None] * xh.float()).reshape(B, S, di).to(x.dtype)
        y = apply_norm(y * F.silu(z), norm_scale, None, "rmsnorm")
        return y @ out_proj
