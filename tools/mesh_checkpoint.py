"""The streamed checkpoint of a training mesh at full size, on four cards:
deepseek-v2-lite-16b at full width and depth in bf16 on 2 x 2 saves its
state (about 157 GB) after one step, and a second launcher run resumes
it (every rank reading the leaves one by one) and takes no step.

    python3 tools/mesh_checkpoint.py [--log FILE]

Each rank's block of every parameter and moment after the resume must
have the bytes the first run ended with (their SHA-256, which each rank
of ``chip_smoke.py --mesh-rank`` records under ``MESH_RANK_STATE=blocks``).
Printed: the card's name and power limit, then the report as one JSON
object: each rank's save and restore seconds, its host and card peaks,
and the bytes on disk.  ``--log`` keeps every line (default
``build/mesh_checkpoint.log``).  The checkpoint goes under ``build/``,
which needs room for it: without four cards or the room the tool says so
and exits 2.  Exit code 0 when every block was restored.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, MESH = "deepseek-v2-lite-16b", (2, 2)
RUN_TIMEOUT = 2400       # one launcher run; a save did not end within 600 s


def drive(card, scratch: Path) -> dict:
    import chip_smoke as cs
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.sharding import MeshShape, make_rules
    from repro_torch.launch.dryrun import cell_memory

    d, m = MESH
    cfg = get_config(ARCH)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        ck = Path(tmp) / "ck"
        args = ["--arch", ARCH, *cs.MESH_FULL_ARGS, "--ckpt-dir", str(ck), "--steps", "1"]
        hashed = {"MESH_RANK_STATE": "blocks"}
        first = cs._launcher_run(Path(tmp), "ckpt-save", args, cfg.dtype, MESH,
                                 RUN_TIMEOUT, hashed)
        on_disk = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
        second = cs._launcher_run(Path(tmp), "ckpt-resume", args, cfg.dtype, MESH,
                                  RUN_TIMEOUT, hashed)
    assert second["lines"] == ["resumed from step 1"], second["lines"]
    state = d * m * cell_memory(cfg, ShapeSpec("ckpt", 512, 8, "train"),
                                MeshShape(("data", "model"), MESH), make_rules(cfg))["alias"]
    ranks = []
    for a, b in zip(first["ranks"], second["ranks"]):
        same = a["hash"] == b["hash"] and a["opt_hash"] == b["opt_hash"]
        ranks.append(dict(rank=a["rank"], save_s=a["save_s"], restore_s=b["resume_s"],
                          host_peak=[a["host_peak_bytes"], b["host_peak_bytes"]],
                          peak=[a["peak_bytes"], b["peak_bytes"]], restored=same))
        cs.log(f"  checkpoint {ARCH} {d} x {m} rank {a['rank']}: save "
               f"{', '.join(f'{t:.1f}' for t in a['save_s'])} s, restore "
               f"{b['resume_s']:.1f} s, host peak {a['host_peak_bytes']:,} / "
               f"{b['host_peak_bytes']:,} bytes, card peak {a['peak_bytes']:,} / "
               f"{b['peak_bytes']:,}; the bytes of its blocks of {len(a['hash'])} "
               f"parameters and {len(a['opt_hash'])} moments restored: {same} [{card}]")
        assert same, (ARCH, a["rank"])
    cs.log(f"  checkpoint {ARCH}: {on_disk:,} bytes on disk (the state {state:,})")
    return dict(arch=ARCH, mesh=f"{d}x{m}", state_bytes=state, on_disk_bytes=on_disk,
                first=first["history"], ranks=ranks)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", default=str(ROOT / "build" / "mesh_checkpoint.log"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    free = shutil.disk_usage(scratch).free
    if n_cards < 4 or free < 200e9:
        print(f"mesh_checkpoint: needs 4 cards and 200 GB free under {scratch}; "
              f"{n_cards} card(s), {free:,} bytes free", file=sys.stderr)
        return 2
    Path(args.log).parent.mkdir(parents=True, exist_ok=True)
    with open(args.log, "w") as log, contextlib.redirect_stdout(log):
        card = chip_smoke.card_line()
        chip_smoke.log(f"card: {card}; {n_cards} card(s)")
        report = drive(card, scratch)
    print(f"card: {card}; {n_cards} card(s)")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
