"""Model layers of the attention-only families in plain PyTorch: norms,
rotary, GQA / sliding-window attention with a KV cache, cross-attention
and the four MLPs.

Conventions, as in the JAX package's layers:

* Each layer has a ``*_specs`` builder returning ``{name: (shape, dtype)}``
  for its parameters; the modules allocate from those specs, so the specs
  (and ``ModelConfig.param_count``) are the modules' parameters without
  any allocation.
* Compute dtype follows the input; norms and softmax run in float32 and
  cast back.  The norm parameters stay float32 while the weights are
  ``cfg.dtype``, so every mixed product is cast explicitly (PyTorch would
  promote bfloat16 x float32 to float32).
* The products the reference writes as einsums are ``matmul``/``einsum``
  here: no fused attention kernel stands in for them.

MLA, MoE and the Mamba-2 block are not served yet (ROADMAP queue 1 item 11
(i), (ii)); :func:`repro_torch.models.model.param_specs` refuses a config
that needs them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Norm", "Attention", "CrossAttention", "MLP",
    "norm_specs", "attention_specs", "cross_attention_specs", "mlp_specs",
    "apply_norm", "rotary_cos_sin", "rotate", "sdpa",
    "causal_mask", "decode_mask", "torch_dtype",
]

Specs = dict  # {name: (shape, dtype name)}


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class _Leaves(nn.Module):
    """A module whose parameters are the leaves of one spec dict, allocated
    uninitialised on ``device`` (``init_params`` or ``convert`` fills them).
    Serving needs no gradients, so none are recorded."""

    def __init__(self, specs: Specs, device):
        super().__init__()
        for name, (shape, dtype) in specs.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=torch_dtype(dtype), device=device),
                requires_grad=False))


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

def norm_specs(cfg, d: int) -> Specs:
    if cfg.norm == "layernorm":
        return {"scale": ((d,), "float32"), "bias": ((d,), "float32")}
    return {"scale": ((d,), "float32")}


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


def sdpa(q, k, v, mask: Optional[torch.Tensor], groups: int) -> torch.Tensor:
    """q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd), mask (Sq, Sk) or None (all
    visible).  Query head h reads kv head h // groups.  Scores in the input
    dtype scaled there, then float32 for the mask and softmax, and the
    weights cast back to v's dtype."""
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
    p = {
        "wq": ((d, H, hd), dt),
        "wk": ((d, KV, hd), dt),
        "wv": ((d, KV, hd), dt),
        "wo": ((H, hd, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = ((H, hd), dt)
        p["bk"] = ((KV, hd), dt)
        p["bv"] = ((KV, hd), dt)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk")."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = wo.shape
    return o.flatten(-2) @ wo.reshape(h * k, d)


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
        q, k, v = _project(x, self.wq), _project(x, self.wk), _project(x, self.wv)
        if self.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
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
        return _out(out, self.wo)


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
    return {
        "wq": ((d, H, hd), dt),
        "wk": ((d, H, hd), dt),
        "wv": ((d, H, hd), dt),
        "wo": ((H, hd, d), dt),
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
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": ((d, f), dt), "w_up": ((d, f), dt),
                "w_down": ((f, d), dt)}
    return {"w_up": ((d, f), dt), "w_down": ((f, d), dt)}


class MLP(_Leaves):
    """swiglu / geglu (gated), gelu, relu2 (``relu(x)**2``); gelu is the
    tanh form, the reference's default."""

    def __init__(self, cfg, device):
        if cfg.act not in ("swiglu", "geglu", "gelu", "relu2"):
            raise ValueError(f"unknown activation {cfg.act!r}")
        super().__init__(mlp_specs(cfg), device)
        self.act = cfg.act

    def forward(self, x):
        if self.act in ("swiglu", "geglu"):
            g = x @ self.w_gate
            g = F.silu(g) if self.act == "swiglu" else F.gelu(g, approximate="tanh")
            h = g * (x @ self.w_up)
        else:
            h = x @ self.w_up
            h = F.gelu(h, approximate="tanh") if self.act == "gelu" else F.relu(h) ** 2
        return h @ self.w_down
