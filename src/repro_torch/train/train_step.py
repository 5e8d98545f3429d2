"""Training step: next-token loss with the MoE aux and z losses, gradient
accumulation over microbatches, layer recomputation, and optional int8
gradient compression (the JAX package's ``train/train_step.py``).

The gradients come from ``torch.autograd.grad`` over the model's
parameters (the reference's ``jax.value_and_grad``).  Microbatches sum
their gradients in float32 buffers, as the reference's ``g0`` does: a
``backward()`` per microbatch would sum them in the parameters' dtype in
``.grad``.  With ``compress_grads`` the gradients take the int8
quantisation of :func:`repro_torch.distributed.fake_quantize_grads` before
the update.

On a mesh (inside :func:`repro_torch.distributed.axis_env` on a
``DeviceMesh``, the parameters DTensors) each microbatch of the whole host
batch (its extras with it) is sharded over ``data`` as it starts, the
logits take the reference's ``("batch", None, "vocab")`` constraint, the
loss and the metrics come back replicated, and each gradient is reduced
to its parameter's placements (and so quantised after the reduction, as
the reference's are).  The cross-entropy's logsumexp and gather have no
DTensor rule over a sharded vocabulary: each rank gathers its rows'
logits over ``model`` and sums their losses, a partial sum over ``data``.
Where the rules shard the sequence over ``model`` (``seq_shard``
configs) each rank instead chunks its own block of (batch, seq) against
the head gathered whole, its sums partial over both axes.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.collectives import fake_quantize_grads
from ..distributed.sharding import current_env, distribute_batch, \
    env_placements, is_dtensor, local_fallback, logical_constraint, on_mesh, \
    replicate, summed_over
from ..models.model import forward_train, lm_head_of
from .optimizer import OptConfig, apply_updates

__all__ = ["TrainConfig", "loss_fn", "grads_of", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 1e-4
    compress_grads: bool = False
    ce_chunk: int = 512          # sequence chunk of the cross-entropy


def _ce_sums(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - gold).sum(), (lse ** 2).sum()


def _chunk_loss(xc, head, labels):
    logits = logical_constraint((xc @ head).float(), "batch", None, "vocab")
    if not (on_mesh() and is_dtensor(logits)):
        return _ce_sums(logits, labels)
    rows = env_placements(("batch", None, None), logits.shape)
    lab = env_placements(("batch", None), labels.shape)
    sums = summed_over(rows)
    return local_fallback(_ce_sums, (logits, labels), (rows, lab),
                          [sums, sums], (rows, lab))


def _chunk_sums(x, head, labels, chunk: int):
    """(nll sum, z sum) over x's rows in sequence chunks (and a remainder
    chunk), so that the (B, S, V) float32 logits never exist at once:
    while gradients are recorded each chunk is checkpointed, its logits
    recomputed in the backward."""
    S = x.shape[1]
    chunk = min(chunk, S)
    bounds = list(range(0, S - chunk + 1, chunk))
    if S % chunk:
        bounds.append(S - S % chunk)
    nll = z = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in bounds:
        hi = min(lo + chunk, S)
        args = (x[:, lo:hi], head, labels[:, lo:hi])
        n, zz = (checkpoint(_chunk_loss, *args, use_reentrant=False)
                 if torch.is_grad_enabled() else _chunk_loss(*args))
        nll, z = nll + n, z + zz
    return nll, z


def _chunk_sums_on_rows(x, head, labels, chunk: int):
    """:func:`_chunk_sums` on a mesh where x's sequence is sharded: each rank
    chunks its own block of (batch, seq) on local tensors, against the
    head gathered whole (slicing the sharded sequence would gather the
    hidden states once a chunk); the sums are partial over the axes that
    split the rows, and so is the head's gradient."""
    from torch.distributed.tensor import Partial, Replicate

    xp = env_placements(("batch", "seq", None), x.shape)
    lp = env_placements(("batch", "seq"), labels.shape)
    rep = tuple(Replicate() for _ in xp)
    summed = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    return local_fallback(lambda x, h, lab: _chunk_sums(x, h, lab, chunk),
                          (x, head, labels), (xp, rep, lp), [summed, summed],
                          (xp, summed, lp))


def _chunked_ce(x, head, labels, chunk: int):
    """Cross-entropy over sequence chunks: x (B, S, d), head (d, V), labels
    (B, S) -> (nll mean, z mean) over the B * S tokens, z = lse²."""
    B, S, _ = x.shape
    on_rows = is_dtensor(x) and any(p.is_shard(1) for p in x.placements)
    nll, z = (_chunk_sums_on_rows if on_rows else _chunk_sums)(x, head, labels, chunk)
    return nll / (B * S), z / (B * S)


def loss_fn(model, batch: dict, cfg, tcfg: TrainConfig):
    """Causal LM loss ``nll + aux_coef * aux + z_coef * z`` (Megatron-style
    z-loss, z = mean(lse²)) -> (loss, {"nll", "aux", "z"}).  ``batch``
    holds ``tokens`` and ``labels`` (B, S) and any extras (``frames``,
    ``patch_embeds``), numpy arrays or tensors."""
    if on_mesh() and is_dtensor(model.embed):
        mesh, rules = current_env()
        batch = distribute_batch(batch, mesh, rules, model.device)
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    x, aux = forward_train(model, batch["tokens"], cfg, extras or None,
                           return_hidden=True)
    labels = batch["labels"]
    labels = labels.long() if is_dtensor(labels) else \
        torch.as_tensor(labels, device=model.device).long()
    nll, z = _chunked_ce(x, lm_head_of(model, cfg), labels, tcfg.ce_chunk)
    nll, z, aux = replicate(nll), replicate(z), replicate(aux)
    loss = nll + tcfg.aux_loss_coef * aux + tcfg.z_loss_coef * z
    return loss, {"nll": nll, "aux": aux, "z": z}


def _value_and_grads(model, batch, cfg, tcfg):
    named = list(model.named_parameters())
    if not all(p.requires_grad for _, p in named):
        raise ValueError("the model records no gradients: call "
                         "model.requires_grad_(True) on the model to train")
    loss, m = loss_fn(model, batch, cfg, tcfg)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    g = {n: torch.zeros_like(p) if gr is None else
         gr.redistribute(p.device_mesh, p.placements) if is_dtensor(gr) else gr
         for (n, p), gr in zip(named, grads)}
    return g, loss.detach(), {k: v.detach() for k, v in m.items()}


def grads_of(model, batch: dict, cfg, tcfg: TrainConfig = TrainConfig()):
    """(gradients {parameter name: tensor}, loss, {"nll", "aux", "z"}).
    One microbatch: gradients in the parameters' dtype.  Several: the
    batch split along its leading axis into ``tcfg.microbatches`` equal
    parts in order, gradients summed in float32 and divided by their
    number, the loss and metrics their means.  On a mesh the gradients
    are DTensors placed as their parameters."""
    mb = tcfg.microbatches
    if mb <= 1:
        return _value_and_grads(model, batch, cfg, tcfg)
    B = len(batch["tokens"])
    if B % mb:
        raise ValueError(f"a batch of {B} does not split into {mb} microbatches")
    acc = {n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in model.named_parameters()}
    loss_sum, ms = 0.0, []
    for i in range(mb):
        sub = {k: v[i * B // mb:(i + 1) * B // mb] for k, v in batch.items()}
        g, loss, m = _value_and_grads(model, sub, cfg, tcfg)
        for n, a in acc.items():
            a.add_(g[n])
        del g
        loss_sum = loss_sum + loss
        ms.append(m)
    inv = 1.0 / mb
    for a in acc.values():
        a.mul_(inv)
    return acc, loss_sum * inv, {k: torch.stack([m[k] for m in ms]).mean()
                                 for k in ms[0]}


def make_train_step(cfg, opt_cfg: OptConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns step(model, opt_state, batch) -> (model, opt_state, metrics):
    the parameters and the state updated in place; metrics ``loss``,
    ``nll``, ``aux``, ``z``, ``lr`` and ``grad_norm`` (0-d tensors)."""

    def step(model, opt_state, batch):
        grads, loss, m = grads_of(model, batch, cfg, tcfg)
        if tcfg.compress_grads:
            grads = fake_quantize_grads(grads)
        model, opt_state, om = apply_updates(model, grads, opt_state, opt_cfg)
        return model, opt_state, {"loss": loss, **m, **om}

    return step
