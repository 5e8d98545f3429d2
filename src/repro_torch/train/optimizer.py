"""Optimizers on an LM's parameters: AdamW and Adafactor, with global-norm
clipping and a linear-warmup cosine schedule (the JAX package's
``train/optimizer.py``).

The state follows the JAX package's parameter layout: its moments are
float32 tensors keyed by the reference's leaf paths (``"embed"``,
``"blocks/1/pattern/0/attn/wq"``; :func:`repro_torch.convert.reference_layout`),
a scan group's leaf stacked along a leading layer axis.  AdamW is
elementwise, so a layer's update reads its row of the stacked moments.
Adafactor is not: it factors the two trailing dimensions of each
reference leaf and clips the update by the RMS over the whole leaf, so it
runs on the stacked leaf (a stacked norm scale (R, d) is factored across
its layers, and a group's layers share one clip), as the reference does.
Updates are computed in float32 and cast to each parameter's dtype, in
place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..convert import reference_layout

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "cosine_lr",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate after ``step`` updates (float32 0-d tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over a dict (or list) of tensors, in
    float32."""
    leaves = grads.values() if isinstance(grads, dict) else grads
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def _factored_dims(shape):
    """Adafactor factors the two trailing dims of >= 2-D leaves."""
    if len(shape) < 2:
        return None
    return (len(shape) - 2, len(shape) - 1)


def _leaves(model):
    """[(path, [(name, parameter)], stacked)] in the reference's layout."""
    params = dict(model.named_parameters())
    return [(path, [(n, params[n]) for n in names], stacked)
            for path, (names, stacked) in reference_layout(model.cfg).items()]


def init_opt_state(model, cfg: OptConfig, device=None) -> dict:
    """Zero state for ``model``'s parameters on ``device`` (the model's by
    default; ``"meta"`` gives the shapes alone): ``{"step", "m", "v"}``
    (AdamW) or ``{"step", "vr", "vc"}`` (Adafactor), the moments ``{path:
    float32 tensor}``; ``step`` an int32 0-d tensor."""
    dev = model.device if device is None else device

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    shapes = {path: ((len(ps), *ps[0][1].shape) if stacked else tuple(ps[0][1].shape))
              for path, ps, stacked in _leaves(model)}
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.kind == "adamw":
        state["m"] = {p: zeros(s) for p, s in shapes.items()}
        state["v"] = {p: zeros(s) for p, s in shapes.items()}
        return state
    if cfg.kind == "adafactor":
        state["vr"], state["vc"] = {}, {}
        for p, s in shapes.items():
            d = _factored_dims(s)
            state["vr"][p] = zeros(s if d is None else s[:d[1]] + s[d[1] + 1:])
            state["vc"][p] = zeros((1,) if d is None else s[:d[0]] + s[d[0] + 1:])
        return state
    raise ValueError(cfg.kind)


@torch.no_grad()
def apply_updates(model, grads: dict, state: dict, cfg: OptConfig):
    """One optimizer step with ``grads`` (``{parameter name: tensor}``), in
    place on ``model``'s parameters and on ``state``.  Returns (model,
    state, {"lr", "grad_norm"})."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm([grads[n] for n, _ in model.named_parameters()])
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) if cfg.clip_norm else 1.0

    if cfg.kind == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        for path, ps, stacked in _leaves(model):
            for r, (n, p) in enumerate(ps):
                g = grads[n].float() * scale
                m = state["m"][path][r] if stacked else state["m"][path]
                v = state["v"][path][r] if stacked else state["v"][path]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                u = u + cfg.weight_decay * p.float()
                p.copy_((p.float() - lr * u).to(p.dtype))
    elif cfg.kind == "adafactor":
        decay = 1.0 - step.float() ** -0.8
        for path, ps, stacked in _leaves(model):
            g = [grads[n].float() for n, _ in ps]
            g = (torch.stack(g) if stacked else g[0]) * scale
            vr, vc = state["vr"][path], state["vc"][path]
            d = _factored_dims(g.shape)
            if d is None:
                vr.copy_(decay * vr + (1 - decay) * g * g)
                u = g / (torch.sqrt(vr) + cfg.eps)
            else:
                r, c = d
                vr.copy_(decay * vr + (1 - decay) * (g * g).mean(dim=c))
                vc.copy_(decay * vc + (1 - decay) * (g * g).mean(dim=r))
                rfac = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
                vhat = rfac.unsqueeze(c) * vc.unsqueeze(r)
                u = g / (torch.sqrt(vhat) + cfg.eps)
            # update clipping (Adafactor d = 1.0) over the whole leaf
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u, min=1.0)
            pf = [p.float() for _, p in ps]
            pf = torch.stack(pf) if stacked else pf[0]
            new = pf - lr * (u + cfg.weight_decay * pf)
            for i, (_, p) in enumerate(ps):
                p.copy_((new[i] if stacked else new).to(p.dtype))
    else:
        raise ValueError(cfg.kind)
    state["step"] = step
    return model, state, {"lr": lr, "grad_norm": gnorm}
