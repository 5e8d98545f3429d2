"""Readings that the limits of ``correct`` are set from, on the card, in
one process a cell (the cell is planned once):

- the program as the cell runs it, over many seeds (the lower readings:
  the largest of each number);
- the control: the program in the next precision down (float32 for
  float64, complex64 for complex128), over a few seeds (the upper
  readings: the smallest of each number).

Each seed is a whole run of the cell's window.  Not run by the benchmark.

  python3 portbench/calibrate.py --workload grid128.newton --seeds 11-22 \\
      --control-seeds 31-33 --seconds 20 --out chiprun_out/cal.json
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOWER = {"float64": "float32", "complex128": "complex64"}


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "torch_kernels")
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import Bench, run_cell

    bench = Bench(ROOT)
    report = {}
    for cell in args.workload:
        w = bench.cell(cell)
        cfg, mix = bench.config(w["config"]), bench.traffic(w["traffic"])
        kind = "complex" if mix["values"] == "complex" else "real"
        low = {"dtype": LOWER[cfg["dtypes"][kind]]}
        plans = {}
        rows = []
        for label, seeds, over in (("program", _seeds(args.seeds), None),
                                   ("control", _seeds(args.control_seeds), low)):
            for seed in seeds:
                t = time.perf_counter()
                out = run_cell(bench, cell, seed, args.seconds, False,
                               overrides=over, plans=plans,
                               log=lambda *a, **k: None)
                row = {"side": label, "seed": seed, "correct": out["correct"],
                       "attempted": out["attempted"], "failed": out["failed"],
                       **{k: c["value"] for k, c in out["checks"].items()},
                       "seconds": time.perf_counter() - t}
                rows.append(row)
                print(cell, json.dumps(row), flush=True)
        summary = {}
        for name in ("berr_max", "ferr_max"):
            prog = [r[name] for r in rows if r["side"] == "program"]
            ctrl = [r[name] for r in rows if r["side"] == "control"]
            summary[name] = {"lower": max(prog), "upper": min(ctrl),
                             "ratio": min(ctrl) / max(prog) if max(prog) > 0 else None}
        report[cell] = {"rows": rows, "summary": summary}
        print(cell, "summary", json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
