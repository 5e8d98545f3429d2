"""The streamed checkpoint of a training mesh at full size, on four cards:
an arch at full width and depth in bf16 on 2 x 2 saves its state after
one step, and a second launcher run resumes it (every rank reading the
leaves one by one) and takes no step.  ``--arch`` picks the config
(default deepseek-v2-lite-16b, whose state is about 157 GB; qwen2.5-3b's
is about 30.9 GB).

    python3 tools/mesh_checkpoint.py [--arch ARCH] [--log FILE]

Each rank's block of every parameter and moment after the resume must
have the bytes the first run ended with (their SHA-256, which each rank
of ``chip_smoke.py --mesh-rank`` records under ``MESH_RANK_STATE=blocks``).
Printed: the card's name and power limit, then the report as one JSON
object: each rank's save and restore seconds and their parts, its host
and card peaks, and the bytes on disk.  The resume must take no step and
leave the checkpoint's files as they were.  ``--log`` keeps every line (default
``build/mesh_checkpoint.log``).  The checkpoint goes under ``build/``,
which needs room for it (the state's bytes as ``cell_memory`` predicts
them, with a quarter more to spare): without four cards or the disk
room the tool says so and exits 2.  Exit code 0 when every block was
restored.
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
ROOM = 1.25              # disk room asked for, over the predicted state


def state_bytes(arch: str) -> int:
    """The checkpointed state of ``arch`` (parameters and AdamW moments,
    every leaf whole, as the checkpoint holds them): ``cell_memory``'s
    alias bytes on a 1 x 1 mesh.  (A rank of 2 x 2 times four counts a
    leaf replicated over ``data`` twice: qwen2.5-3b has no ZeRO-3.)"""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.sharding import MeshShape, make_rules
    from repro_torch.launch.dryrun import cell_memory

    cfg = get_config(arch)
    return cell_memory(cfg, ShapeSpec("ckpt", 512, 8, "train"),
                       MeshShape(("data", "model"), (1, 1)),
                       make_rules(cfg))["alias"]


def _files(directory: Path) -> dict:
    """Each file under ``directory``: its size and modification time."""
    return {str(f.relative_to(directory)): (f.stat().st_size, f.stat().st_mtime_ns)
            for f in sorted(directory.rglob("*")) if f.is_file()}


def _parts(parts: dict) -> str:
    return "(" + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()
                           if k.endswith("_s")) + ")"


def drive(card, scratch: Path, arch: str = ARCH) -> dict:
    import chip_smoke as cs
    from repro_torch.configs import get_config

    d, m = MESH
    cfg = get_config(arch)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        ck = Path(tmp) / "ck"
        args = ["--arch", arch, *cs.MESH_FULL_ARGS, "--ckpt-dir", str(ck), "--steps", "1"]
        hashed = {"MESH_RANK_STATE": "blocks"}
        first = cs._launcher_run(Path(tmp), "ckpt-save", args, cfg.dtype, MESH,
                                 RUN_TIMEOUT, hashed)
        files = _files(ck)
        on_disk = sum(size for size, _ in files.values())
        second = cs._launcher_run(Path(tmp), "ckpt-resume", args, cfg.dtype, MESH,
                                  RUN_TIMEOUT, hashed)
        unchanged = _files(ck) == files
    assert second["lines"] == ["resumed from step 1"], second["lines"]
    assert second["history"] == [] and unchanged, "the resume took a step or wrote"
    state = state_bytes(arch)
    ranks = []
    for a, b in zip(first["ranks"], second["ranks"]):
        same = a["hash"] == b["hash"] and a["opt_hash"] == b["opt_hash"]
        ranks.append(dict(rank=a["rank"], save_s=a["save_s"], restore_s=b["resume_s"],
                          save_parts=a["save_parts"], restore_parts=b.get("resume_parts"),
                          host_peak=[a["host_peak_bytes"], b["host_peak_bytes"]],
                          peak=[a["peak_bytes"], b["peak_bytes"]], restored=same))
        cs.log(f"  checkpoint {arch} {d} x {m} rank {a['rank']}: save "
               f"{', '.join(f'{t:.1f}' for t in a['save_s'])} s "
               f"{_parts(a['save_parts'][-1] if a['save_parts'] else {})}, restore "
               f"{b['resume_s']:.1f} s {_parts(b.get('resume_parts') or {})}, "
               f"host peak {a['host_peak_bytes']:,} / "
               f"{b['host_peak_bytes']:,} bytes, card peak {a['peak_bytes']:,} / "
               f"{b['peak_bytes']:,}; the bytes of its blocks of {len(a['hash'])} "
               f"parameters and {len(a['opt_hash'])} moments restored: {same} [{card}]")
        assert same, (arch, a["rank"])
    cs.log(f"  checkpoint {arch}: {on_disk:,} bytes on disk (the state {state:,})")
    return dict(arch=arch, mesh=f"{d}x{m}", state_bytes=state, on_disk_bytes=on_disk,
                first=first["history"], ranks=ranks)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH)
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
    need = ROOM * state_bytes(args.arch)
    if n_cards < 4 or free < need:
        print(f"mesh_checkpoint: needs 4 cards and {need:,.0f} bytes free under "
              f"{scratch}; {n_cards} card(s), {free:,} bytes free", file=sys.stderr)
        return 2
    Path(args.log).parent.mkdir(parents=True, exist_ok=True)
    with open(args.log, "w") as log, contextlib.redirect_stdout(log):
        card = chip_smoke.card_line()
        chip_smoke.log(f"card: {card}; {n_cards} card(s)")
        report = drive(card, scratch, args.arch)
    print(f"card: {card}; {n_cards} card(s)")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
