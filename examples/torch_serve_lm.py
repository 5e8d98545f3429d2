"""Serve a small LM on the PyTorch port with batched prefill+decode and
the dependency-aware scheduler (levelizer reuse from the paper's core).
Runs on the card; ``--device cpu`` runs on the host.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("stablelm-1.6b").reduced()
    cfg = dataclasses.replace(cfg, num_layers=args.layers,
                              d_model=args.d_model)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    engine = ServeEngine(cfg, model, device=dev)
    rng = np.random.default_rng(0)

    # plain batched generation
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 24)).astype(np.int32)
    out = engine.generate_batch(prompts, max_new=args.max_new)
    print("batched generation:", out.shape)

    # dependency-aware scheduling: request 2 extends request 0's output
    reqs = [
        Request(rid=0, tokens=prompts[0], max_new=8),
        Request(rid=1, tokens=prompts[1], max_new=8),
        Request(rid=2, tokens=prompts[2][:8], max_new=8, parent=0),
        Request(rid=3, tokens=prompts[3][:8], max_new=8, parent=1),
    ]
    results = engine.run(reqs, batch_size=2)
    for rid in sorted(results):
        print(f"request {rid}: {results[rid][:8].tolist()}")
    return dict(cfg=cfg, prompts=prompts, batch=out, requests=results)


if __name__ == "__main__":
    main()
