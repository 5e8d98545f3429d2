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

On a mesh the parameters and gradients are DTensors.  Each moment is a
DTensor placed as its parameter (a stacked leaf's layer axis replicated;
Adafactor's statistics without the dimension they reduce): the per-card
state.  AdamW updates each rank's blocks on their local tensors;
:func:`global_norm` is the norm of the whole gradient (one all-reduce of
each rank's share of the sum of squares); Adafactor's row and column
means and its clip run as DTensor reductions across the ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..convert import reference_layout
from ..distributed.sharding import MeshSharding, is_dtensor, moment_sharding, \
    plain_as_replicated, spec_of, zeros_on

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
    float32.  DTensors (placed as their parameters, none partial) count
    whole: each rank sums the squares of its blocks, each divided by the
    number of ranks that hold the same block, and one all-reduce adds the
    shares; every rank gets the norm as a plain tensor."""
    leaves = list(grads.values() if isinstance(grads, dict) else grads)
    if not any(map(is_dtensor, leaves)):
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = next(g for g in leaves if is_dtensor(g)).device_mesh
    share = 0.0
    for g in leaves:
        if any(isinstance(p, Partial) for p in g.placements):
            raise ValueError("global_norm takes gradients reduced to their "
                             "parameters' placements, not partial sums")
        copies = math.prod(mesh.size(i) for i, p in enumerate(g.placements)
                           if isinstance(p, Replicate))
        share = share + torch.sum(torch.square(g.to_local().float())) / copies
    import torch.distributed as dist

    if mesh.size() == dist.get_world_size():
        dist.all_reduce(share)      # one collective over the whole mesh
        return torch.sqrt(share)
    total = DTensor.from_local(share, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return torch.sqrt(total.full_tensor())


def _local(t):
    """A DTensor's local block (a view: writes reach the DTensor), or the
    tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _assign(dst, value):
    """``dst.copy_(value)``; a DTensor ``value`` first takes ``dst``'s
    placements."""
    if is_dtensor(dst):
        value = value.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(value)


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
    leaves = _leaves(model)
    first = {path: (ps[0][1], stacked) for path, ps, stacked in leaves}
    meshed = str(dev) != "meta" and any(is_dtensor(p) for p, _ in first.values())

    def zeros(path, shape, drop=None):
        if not meshed:
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        p, stacked = first[path]
        sh = moment_sharding(MeshSharding(p.device_mesh, spec_of(p)), stacked, drop)
        return zeros_on(shape, sh, torch.float32, dev)

    shapes = {path: ((len(ps), *ps[0][1].shape) if stacked else tuple(ps[0][1].shape))
              for path, ps, stacked in leaves}
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.kind == "adamw":
        state["m"] = {p: zeros(p, s) for p, s in shapes.items()}
        state["v"] = {p: zeros(p, s) for p, s in shapes.items()}
        return state
    if cfg.kind == "adafactor":
        state["vr"], state["vc"] = {}, {}
        for p, s in shapes.items():
            d = _factored_dims(s)
            state["vr"][p] = (zeros(p, s) if d is None else
                              zeros(p, s[:d[1]] + s[d[1] + 1:], d[1]))
            state["vc"][p] = (zeros(p, (1,), 0) if d is None else
                              zeros(p, s[:d[0]] + s[d[0] + 1:], d[0]))
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
            ms, vs = _local(state["m"][path]), _local(state["v"][path])
            for r, (n, p) in enumerate(ps):
                g = _local(grads[n]).float() * scale
                m = ms[r] if stacked else ms
                v = vs[r] if stacked else vs
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                p = _local(p)
                u = u + cfg.weight_decay * p.float()
                p.copy_((p.float() - lr * u).to(p.dtype))
    elif cfg.kind == "adafactor":
        decay = 1.0 - step.float() ** -0.8
        with _plain_replicated(grads):
            _adafactor(model, grads, state, cfg, lr, scale, decay)
    else:
        raise ValueError(cfg.kind)
    state["step"] = step
    return model, state, {"lr": lr, "grad_norm": gnorm}


def _plain_replicated(grads):
    """On a mesh, plain tensors (the step's scalars) meeting DTensors count
    as replicated."""
    if not any(map(is_dtensor, grads.values())):
        return contextlib.nullcontext()
    return plain_as_replicated()


def _adafactor(model, grads, state, cfg, lr, scale, decay):
    for path, ps, stacked in _leaves(model):
        g = [grads[n].float() for n, _ in ps]
        g = (torch.stack(g) if stacked else g[0]) * scale
        vr, vc = state["vr"][path], state["vc"][path]
        d = _factored_dims(g.shape)
        if d is None:
            _assign(vr, decay * vr + (1 - decay) * g * g)
            u = g / (torch.sqrt(vr) + cfg.eps)
        else:
            r, c = d
            _assign(vr, decay * vr + (1 - decay) * (g * g).mean(dim=c))
            _assign(vc, decay * vc + (1 - decay) * (g * g).mean(dim=r))
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
            _assign(p, (new[i] if stacked else new).to(p.dtype))
