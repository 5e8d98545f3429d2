"""Read the bar of ``chip_smoke.py`` phase 20 (c) on one NVIDIA GPU: the
float32 gradient check of qwen2.5-3b at full width and depth at several
central-difference steps.

    python3 tools/grad_check_readings.py [--dloss 1e-3 2e-3 ...]

For each dloss, ``chip_smoke.drive_grad_check`` compares, for each group
of parameters (the embedding, each layer, the final norm), autograd's
derivative of the loss along the group's g / |g| (that is |g|) with
central differences at h = dloss / |g| and h / 2, Richardson-extrapolated
(each group's step moves the loss by about dloss), sound and
with the planted faults (the tied head's part of the embedding's
gradient dropped; layer 18's gradient zeroed, and 1 % short).  One JSON
line a dloss: every group's sound reading, |g| and extrapolated
difference, and the faults' readings.  The check's bar is not applied
here: the readings are what it is set from.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

DLOSS = (5e-4, 1e-3, 2e-3, 5e-3, 1e-2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dloss", type=float, nargs="+", default=list(DLOSS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_check_readings: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    for dloss in args.dloss:
        cs.GRAD_CHECK = dict(cs.GRAD_CHECK, dloss=dloss)
        r = cs.drive_grad_check(dev, card)
        print(json.dumps({"card": card, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
