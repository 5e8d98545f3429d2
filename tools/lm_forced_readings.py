"""Read the bar of ``chip_smoke.py`` phase 17 (a) on one NVIDIA GPU: the
bfloat16 teacher-forced check of qwen2.5-3b at full width, sound and with
each planted fault, at several prompt lengths, decode depths and seeds.

    python3 tools/lm_forced_readings.py

The model is phase 17's (the port's seeded init, bfloat16, TF32 off).  For
seeds 1 and 2, prompts of 8, 16, 32 and 128 tokens and 2 or 4 forced decode
steps at B = 4, ``chip_smoke._teacher_forced`` gives the largest |logit|
difference against ``forward_train`` with no fault, with "skip_write" and
with "position".  One JSON line a reading; the last line is the largest
sound reading and the smallest fault reading at each prompt length.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_forced_readings: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    cfg = get_config(cs.LM_ARCH)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED),
                        device=dev)
    summary: dict = {}
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        for P in (8, 16, 32, 128):
            for D in (2, 4):
                tokens = rng.integers(0, cfg.vocab_size, size=(4, P + D)).astype(np.int32)
                r = {f or "sound": cs._teacher_forced(model, cfg, tokens, P, f)
                     for f in (None, "skip_write", "position")}
                line = dict(seed=seed, P=P, D=D, **{k: v[0] for k, v in r.items()},
                            argmax_equal=r["sound"][1], scale=r["sound"][2],
                            gap=r["sound"][3])
                print(json.dumps(line), flush=True)
                s = summary.setdefault(P, dict(sound=0.0, fault=float("inf")))
                s["sound"] = max(s["sound"], line["sound"])
                s["fault"] = min(s["fault"], line["skip_write"], line["position"])
    print(json.dumps({"largest_sound_smallest_fault": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
