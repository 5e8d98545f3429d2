"""Serving driver: batched generation with the ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --reduced --batch 4 --prompt-len 32 --max-new 16

The JAX package's flags and lines, plus ``--device`` (default: the card;
``cpu`` runs here).  Parameters come from the port's seeded init.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.model import init_params
from ..serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=0,
                    help="run the dependency-aware scheduler with N requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    extras = None
    if cfg.frontend == "audio_stub":
        extras = {"frames": rng.normal(size=(args.batch, cfg.encoder_seq,
                                             cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        extras = {"patch_embeds": rng.normal(size=(args.batch, cfg.frontend_tokens,
                                                   cfg.d_model)).astype(np.float32)}
    engine = ServeEngine(cfg, params, extras, device=dev)

    if args.requests:
        reqs = []
        for i in range(args.requests):
            parent = i - 1 if i % 3 == 2 else None  # every 3rd extends previous
            reqs.append(Request(
                rid=i,
                tokens=rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                max_new=args.max_new, parent=parent))
        t0 = time.time()
        results = engine.run(reqs, batch_size=args.batch)
        print(f"{len(results)} requests served in {time.time()-t0:.1f}s "
              f"(dependency levels honoured)")
        return results

    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = engine.generate_batch(prompts, args.max_new)
    dt = time.time() - t0
    tps = args.batch * args.max_new / dt
    print(f"generated {out.shape} in {dt:.1f}s ({tps:.1f} tok/s)")
    print("sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
