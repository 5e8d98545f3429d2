"""Run the depth-cut parts of ``chip_smoke.py``'s later phases alone on one
NVIDIA GPU: phase 19 (a)-(c) (mamba2-2.7b at ``SSM_LAYERS`` layers: serving,
the bf16 and float32 forced checks with their planted faults), phase 20
(a) and (d) (qwen2.5-3b at ``TRAIN["layers"]`` layers: the steps, the
checkpoint and the bit-for-bit resume), phase 21 (b) (that step as a dry-run
cell against the card's allocation) and phase 22 (the training step on a
mesh of ranks).

    python3 tools/late_phases.py

Each phase's checks hold as in the script (an assertion ends the run).
The lines are the script's own, with the seconds of each part; TF32 is off
as in the script.  Exit code 0 when every check held.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("late_phases: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log("card:", card)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    t = time.perf_counter()
    _, model, prompts = cs.drive_ssm_serve(dev, card)
    cs.log("19a", round(time.perf_counter() - t, 1))
    t1 = time.perf_counter()
    forced = cs.drive_ssm_forced(dev, model, prompts)
    cs.log("19c", round(time.perf_counter() - t1, 1))
    del model
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    f32 = cs.drive_ssm_f32(dev)
    cs.log("19b", round(time.perf_counter() - t1, 1))
    cs.log("phase 19 (a)-(c):", round(time.perf_counter() - t, 1),
           json.dumps(forced["max_abs_err"]), json.dumps(f32["faults"]), f32["max_abs_err"])
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        train = cs.drive_train(dev, card, Path(tmp) / "ckpt")
    cs.log("phase 20 (a)+(d):", round(time.perf_counter() - t, 1))
    cs.drive_dryrun_card(train, card)
    r22 = cs.drive_phase22(card, scratch)
    cs.log(json.dumps({k: v for k, v in r22["a"].items() if k != "runs"})[:3000])
    cs.log("runs", json.dumps({k: v["wall_s"] for k, v in r22["a"]["runs"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
