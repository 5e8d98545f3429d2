"""Training launcher: a model of any arch from the port's seeded init, the
deterministic resumable data pipeline, checkpoints with auto-resume, a
preemption flush, optional int8 gradient compression and microbatch
accumulation.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

The JAX package's flags and lines, plus ``--device`` (default: the card;
``cpu`` runs here).  A checkpoint is labelled with the steps it has
taken, and a resumed run goes on with the next batch.

On a mesh: one process a rank, as ``torch.distributed.run`` starts them,
``--data-parallel d --model-parallel m`` with ``d * m`` processes,

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc_per_node 4 -m repro_torch.launch.train --arch qwen2.5-3b \
      --reduced --device cpu --data-parallel 2 --model-parallel 2

each rank on its own card over NCCL, or over gloo with ``--device cpu``.
As the reference's launcher does, the parameters are placed by the rules'
``tree_shardings`` (ZeRO-3 over ``data`` with ``cfg.fsdp``), the moments
take their parameters' placements, and each step's batch (every rank
draws the same one from the pipeline) is sharded over ``data``; the
activations take the reference's logical constraints under the same
``make_rules(cfg)``: tensor parallelism over ``model``, and for a
``seq_shard`` config (``rules["seq"] = "model"``) the sequence sharded
over ``model`` at the ``"seq"`` sites, so ``--seq`` must divide over the
model ranks.  Rank 0 prints the lines and writes ``--metrics-out`` and
the checkpoints: whole logical leaves, each gathered as the writer takes
it and read back leaf by leaf on a mesh of any shape, each rank keeping
its blocks.  The batch must divide by ``d`` times ``--microbatches``.  A
process that no launcher started takes no mesh of several ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
from ..convert import load_lm_params, lm_params_to_tensors, nest_paths, \
    opt_state_from_arrays, reference_layout
from ..data.pipeline import TokenPipeline
from ..device import resolve_device
from ..distributed.sharding import axis_env, is_dtensor, make_rules, shard_of
from ..models.model import init_params
from ..train.checkpoint import Checkpointer, checkpoint_leaves, iter_checkpoint, \
    latest_step
from ..train.fault import PreemptionGuard
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_step import TrainConfig, make_train_step
from .mesh import make_host_mesh, rank_device


def build_cfg(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    over = {}
    if args.layers:
        over["num_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
        over["head_dim"] = max(args.d_model // max(cfg.num_heads, 1), 8)
    if args.d_ff:
        over["d_ff"] = args.d_ff
    if args.vocab:
        over["vocab_size"] = args.vocab
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return cfg


def extras_fn_for(cfg):
    if cfg.frontend == "audio_stub":
        return lambda rng, b: {
            "frames": rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return lambda rng, b: {
            "patch_embeds": rng.normal(size=(b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    return None


def _meshed(model) -> bool:
    return any(map(is_dtensor, model.parameters()))


def train_state(model, opt_state, keep: bool = True):
    """What a checkpoint holds: ``{"params", "opt"}`` in the JAX package's
    layout, bfloat16 parameters kept (tensors on the model's device; the
    checkpoint copies them to the host).  On a mesh every rank calls it:
    the rank that ``keep`` s the state gets its leaves as ``(path, tensor)``
    pairs from a generator, which ``save_checkpoint`` streams, each leaf
    gathered whole onto the card as the writer takes it; every other rank
    takes part in the same gathers, in the same order, here, and gets
    None."""
    opt = {k: v if k == "step" else nest_paths(v) for k, v in opt_state.items()}
    if not _meshed(model):
        return {"params": lm_params_to_tensors(model), "opt": opt}
    leaves = _gathered_leaves(model, opt_state, keep)
    if keep:
        return leaves
    for _ in leaves:
        pass
    return None


def _gathered_leaves(model, opt_state, keep: bool):
    params = dict(model.named_parameters())

    def whole(t):
        t = t.detach().full_tensor() if is_dtensor(t) else t.detach()
        return t if keep else None

    def stacked_rows(names, stacked):
        rows = [whole(params[n]) for n in names]
        return torch.stack(rows) if keep and stacked else rows[0]

    # no leaf is bound here: each is freed once it is written
    for path, (names, stacked) in reference_layout(model.cfg).items():
        yield f"params/{path}", stacked_rows(names, stacked)
    for key, sub in opt_state.items():
        if key == "step":
            yield "opt/step", whole(sub)
        else:
            for path, t in sub.items():
                yield f"opt/{key}/{path}", whole(t)


def load_train_state(model, opt_cfg: OptConfig, tree, device) -> dict:
    """Load a restored ``{"params", "opt"}`` into ``model``; returns the
    optimizer state, which must have the leaves and shapes of
    ``opt_cfg``'s state for ``model``."""
    new = opt_state_from_arrays(tree["opt"], device)
    _check_opt_shapes(model, opt_cfg, {k: {p: tuple(t.shape) for p, t in v.items()}
                                       for k, v in new.items() if k != "step"})
    load_lm_params(model, tree["params"])
    return new


def _check_opt_shapes(model, opt_cfg, shapes: dict):
    want = init_opt_state(model, opt_cfg, device="meta")
    if shapes != {k: {p: tuple(t.shape) for p, t in v.items()}
                  for k, v in want.items() if k != "step"}:
        raise ValueError("the checkpoint's optimizer state is not this "
                         "optimizer's (another kind or another model)")


def resume_on_mesh(model, opt_cfg: OptConfig, directory, step: int) -> dict:
    """Load the checkpoint of ``step`` into a meshed ``model`` leaf by
    leaf: each rank reads every leaf, keeps its blocks of it and drops it
    (see ``iter_checkpoint``), so the host holds a few leaves at once, not
    the state.  Returns the optimizer state, placed as its parameters."""
    specs = checkpoint_leaves(directory, step)
    layout = {f"params/{path}": v for path, v in reference_layout(model.cfg).items()}
    stored = {k for k in specs if k.startswith("params/")}
    if stored != layout.keys():
        raise KeyError(f"parameter tree of {model.cfg.name}: missing "
                       f"{sorted(layout.keys() - stored)}, unexpected "
                       f"{sorted(stored - layout.keys())}")
    shapes = {}
    for key, spec in specs.items():
        if key.startswith("opt/") and key != "opt/step":
            kind, path = key[4:].split("/", 1)
            shapes.setdefault(kind, {})[path] = tuple(spec["shape"])
    _check_opt_shapes(model, opt_cfg, shapes)
    state = init_opt_state(model, opt_cfg)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, leaf in iter_checkpoint(directory, step, [*layout, *(
                k for k in specs if k.startswith("opt/"))]):
            if key == "opt/step":
                state["step"] = leaf.to(device=state["step"].device, dtype=torch.int32)
            elif key in layout:
                names, stacked = layout[key]
                for r, name in enumerate(names):
                    _put_block(params[name], leaf[r] if stacked else leaf, name)
            else:
                kind, path = key[4:].split("/", 1)
                _put_block(state[kind][path], leaf, key)
    return state


def _put_block(dst, whole, name):
    """Copy ``dst``'s block of the whole leaf ``whole`` into it, cast to
    its dtype."""
    if tuple(whole.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(whole.shape)}, expected {tuple(dst.shape)}")
    if is_dtensor(dst):
        dst.to_local().copy_(shard_of(whole, dst.device_mesh, dst.placements))
    else:
        dst.copy_(whole)


def _check_mesh_run(args, cfg):
    """Refuse a mesh that this run's ranks (1 without a launcher) cannot
    hold, a batch that does not divide over it, and a sequence that a
    ``seq_shard`` config cannot split over its model ranks (the rules'
    divisibility guard would leave it whole without a word)."""
    d, m = args.data_parallel, args.model_parallel
    world = int(os.environ.get("WORLD_SIZE", 1))
    if d * m != world:
        how = ("start it with python -m torch.distributed.run --nproc_per_node "
               f"{d * m}" if world == 1 else f"this run has {world} ranks")
        raise ValueError(f"a {d} x {m} mesh takes {d * m} ranks, one a process; {how}")
    if args.batch % (d * args.microbatches):
        raise ValueError(f"a batch of {args.batch} does not divide over {d} data "
                         f"ranks times {args.microbatches} microbatches")
    if make_rules(cfg)["seq"] == "model" and args.seq % m:
        raise ValueError(f"{cfg.name} shards the sequence over the model axis "
                         f"(seq_shard: rules[\"seq\"] = \"model\"); --seq {args.seq} "
                         f"does not divide over {m} model ranks")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = build_cfg(args)
    meshed = "WORLD_SIZE" in os.environ or args.data_parallel * args.model_parallel > 1
    mesh = rules = None
    if meshed:
        _check_mesh_run(args, cfg)
        dev = rank_device(args.device)
        mesh = make_host_mesh(args.data_parallel, args.model_parallel, device=dev.type)
        rules = make_rules(cfg)
    else:
        dev = resolve_device(args.device)
    try:
        return _train(args, cfg, dev, mesh, rules)
    finally:
        if meshed:
            torch.distributed.destroy_process_group()


def _train(args, cfg, dev, mesh, rules):
    opt_cfg = OptConfig(lr=args.lr, warmup=min(50, args.steps // 10 + 1),
                        total_steps=args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches,
                       compress_grads=args.compress_grads)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev, mesh=mesh, rules=rules)
    model.requires_grad_(True)
    step_fn = make_train_step(cfg, opt_cfg, tcfg)

    pipe = TokenPipeline(cfg.padded_vocab, args.batch, args.seq,
                         seed=args.seed, extras_fn=extras_fn_for(cfg))
    ckpt = Checkpointer(args.ckpt_dir, every=args.ckpt_every) if args.ckpt_dir else None
    start, opt_state = 0, None
    if ckpt:
        last = latest_step(ckpt.directory)
        if last is not None and mesh is not None:
            opt_state = resume_on_mesh(model, opt_cfg, ckpt.directory, last)
        elif last is not None:
            state, _ = ckpt.resume(device=dev)
            opt_state = load_train_state(model, opt_cfg, state, dev)
            del state
        if last is not None:
            start = last
            say(f"resumed from step {start}")
        pipe.skip_to(start)
    if opt_state is None:
        opt_state = init_opt_state(model, opt_cfg)

    history = []
    env = axis_env(mesh, rules) if mesh is not None else contextlib.nullcontext()
    with env, PreemptionGuard() as guard:
        t0 = time.time()
        for step in range(start, args.steps):
            model, opt_state, metrics = step_fn(model, opt_state, pipe.batch_at(step))
            if step % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v.full_tensor() if is_dtensor(v) else v)
                     for k, v in metrics.items()}
                dt = time.time() - t0
                say(f"step {step:5d} loss {m['loss']:.4f} nll {m['nll']:.4f} "
                    f"gnorm {m['grad_norm']:.2f} ({dt:.1f}s)", flush=True)
                history.append({"step": step, **m, "elapsed_s": dt})
            done = step + 1
            stop = guard.agreed(dev) if mesh is not None else guard.should_stop
            if ckpt:
                ckpt.maybe_save(done, lambda: train_state(model, opt_state, keep=rank0),
                                force=stop or done == args.steps)
            if stop:
                say("preemption signal — checkpoint flushed, exiting")
                break
    if args.metrics_out and rank0:
        Path(args.metrics_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.metrics_out).write_text(json.dumps(history, indent=1))
    return history


if __name__ == "__main__":
    main()
