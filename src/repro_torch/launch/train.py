"""Training launcher: a model of any arch from the port's seeded init, the
deterministic resumable data pipeline, checkpoints with auto-resume, a
preemption flush, optional int8 gradient compression and microbatch
accumulation.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

The JAX package's flags and lines, plus ``--device`` (default: the card;
``cpu`` runs here).  One device: ``--data-parallel`` and
``--model-parallel`` above 1 raise, since the step does not run on
DTensors over a mesh of cards (the dry run traces the mesh's per-card
step instead: ``launch/dryrun.py``).  A checkpoint is labelled with the steps it
has taken, and a resumed run goes on with the next batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
from ..convert import load_lm_params, lm_params_to_tensors, nest_paths, \
    opt_state_from_arrays
from ..data.pipeline import TokenPipeline
from ..device import resolve_device
from ..models.model import init_params
from ..train.checkpoint import Checkpointer
from ..train.fault import PreemptionGuard
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_step import TrainConfig, make_train_step


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


def train_state(model, opt_state) -> dict:
    """What a checkpoint holds: ``{"params", "opt"}`` in the JAX package's
    layout, bfloat16 parameters kept (tensors on the model's device; the
    checkpoint copies them to the host)."""
    opt = {k: v if k == "step" else nest_paths(v) for k, v in opt_state.items()}
    return {"params": lm_params_to_tensors(model), "opt": opt}


def load_train_state(model, opt_cfg: OptConfig, tree, device) -> dict:
    """Load a restored ``{"params", "opt"}`` into ``model``; returns the
    optimizer state, which must have the leaves and shapes of
    ``opt_cfg``'s state for ``model``."""
    new = opt_state_from_arrays(tree["opt"], device)
    want = init_opt_state(model, opt_cfg, device="meta")
    if {k: {p: tuple(t.shape) for p, t in v.items()} for k, v in new.items()
            if k != "step"} != {k: {p: tuple(t.shape) for p, t in v.items()}
                                for k, v in want.items() if k != "step"}:
        raise ValueError("the checkpoint's optimizer state is not this "
                         "optimizer's (another kind or another model)")
    load_lm_params(model, tree["params"])
    return new


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
    if args.data_parallel > 1 or args.model_parallel > 1:
        raise NotImplementedError(
            f"--data-parallel {args.data_parallel} --model-parallel "
            f"{args.model_parallel}: the step does not run on a mesh of cards "
            f"(launch/dryrun.py traces one); this launcher trains on one device")

    cfg = build_cfg(args)
    dev = resolve_device(args.device)
    opt_cfg = OptConfig(lr=args.lr, warmup=min(50, args.steps // 10 + 1),
                        total_steps=args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches,
                       compress_grads=args.compress_grads)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    model.requires_grad_(True)
    step_fn = make_train_step(cfg, opt_cfg, tcfg)

    pipe = TokenPipeline(cfg.padded_vocab, args.batch, args.seq,
                         seed=args.seed, extras_fn=extras_fn_for(cfg))
    ckpt = Checkpointer(args.ckpt_dir, every=args.ckpt_every) if args.ckpt_dir else None
    start, opt_state = 0, None
    if ckpt:
        state, start = ckpt.resume(device=dev)
        if state is not None:
            opt_state = load_train_state(model, opt_cfg, state, dev)
            del state
            print(f"resumed from step {start}")
        pipe.skip_to(start)
    if opt_state is None:
        opt_state = init_opt_state(model, opt_cfg)

    history = []
    with PreemptionGuard() as guard:
        t0 = time.time()
        for step in range(start, args.steps):
            model, opt_state, metrics = step_fn(model, opt_state, pipe.batch_at(step))
            if step % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                print(f"step {step:5d} loss {m['loss']:.4f} nll {m['nll']:.4f} "
                      f"gnorm {m['grad_norm']:.2f} ({dt:.1f}s)", flush=True)
                history.append({"step": step, **m, "elapsed_s": dt})
            done = step + 1
            if ckpt:
                ckpt.maybe_save(done, lambda: train_state(model, opt_state),
                                force=guard.should_stop or done == args.steps)
            if guard.should_stop:
                print("preemption signal — checkpoint flushed, exiting")
                break
    if args.metrics_out:
        Path(args.metrics_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.metrics_out).write_text(json.dumps(history, indent=1))
    return history


if __name__ == "__main__":
    main()
