"""Run phase 22 of ``chip_smoke.py`` alone: the training step on a mesh of
ranks, (a) and, with 4 cards or more, (b).

    python3 tools/mesh_train_phase.py [--log FILE]

On a machine with four cards this is the phase's whole cost, without
the phases before it (about 5.5 minutes on one H100 80GB HBM3 at
700 W).  The card's name
and power limit come first; the last line is the phase's report as one
JSON object (``chip_smoke.drive_phase22``'s); ``--log`` keeps every line
(default ``build/mesh_train_phase.log``).
Exit code 0 when every check of the phase held.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", default=str(ROOT / "build" / "mesh_train_phase.log"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("mesh_train_phase: no CUDA device is available", file=sys.stderr)
        return 2
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    Path(args.log).parent.mkdir(parents=True, exist_ok=True)
    with open(args.log, "w") as log, contextlib.redirect_stdout(log):
        card = chip_smoke.card_line()
        chip_smoke.log(f"card: {card}; {torch.cuda.device_count()} card(s)")
        report = chip_smoke.drive_phase22(card, scratch)
    print(f"card: {card}; {torch.cuda.device_count()} card(s)")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
