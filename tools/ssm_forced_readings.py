"""Read the bar of ``chip_smoke.py`` phase 19 (c) on one NVIDIA GPU: the
bfloat16 teacher-forced check of mamba2-2.7b at full width and depth,
sound and with each planted fault, at several prompt lengths, decode
depths and seeds.

    python3 tools/ssm_forced_readings.py [--layers N]

The model is phase 19 (a)'s: the port's seeded init in bfloat16, TF32 off,
at its 64 layers or cut to ``--layers``.  For seeds 1 and 2, prompts of
32 tokens with 4 forced decode steps (one short chunk) and of 256 and
1024 tokens with 128 steps (every full pass whole chunks of 128) at
B = 4, ``chip_smoke._ssm_forced`` gives the largest |logit| difference
against ``forward_train`` with no fault and with each of "chunk_state",
"skip_decay", "conv_late" and "skip_D".  One JSON line a reading; the
last line is the largest sound reading and the smallest reading of each
fault at each prompt length.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

LENGTHS = ((32, 4), (256, 128), (1024, 128))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_forced_readings: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    base = get_config(cs.SSM_ARCH)
    cfg = dataclasses.replace(base, num_layers=args.layers or base.num_layers)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED),
                        device=dev)
    summary: dict = {}
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        for P, D in LENGTHS:
            tokens = rng.integers(0, cfg.vocab_size, size=(4, P + D)).astype(np.int32)
            r = cs._ssm_forced(model, cfg, tokens, P, (None, *cs.SSM_FAULTS))
            line = dict(seed=seed, P=P, D=D, **{k: v[0] for k, v in r.items()},
                        argmax_equal=r["sound"][1], scale=r["sound"][2],
                        gap=r["sound"][3])
            print(json.dumps(line), flush=True)
            s = summary.setdefault(P, dict(sound=0.0, **{f: float("inf")
                                                         for f in cs.SSM_FAULTS}))
            s["sound"] = max(s["sound"], line["sound"])
            for f in cs.SSM_FAULTS:
                s[f] = min(s[f], line[f])
    print(json.dumps({"layers": cfg.num_layers, "largest_sound_smallest_fault": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
