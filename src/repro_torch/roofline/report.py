"""Roofline tables from the port's dry-run JSON records (the JAX
package's ``roofline/report.py``).  The numbers are computed with the H100
constants of :mod:`repro_torch.roofline.analysis`, not measured.

  PYTHONPATH=src python -m repro_torch.roofline.report experiments/dryrun_torch
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def load(out_dir) -> list[dict]:
    recs = []
    for f in sorted(Path(out_dir).glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("ok"):
            recs.append(r)
    return recs


def table(recs, mesh: str = "16x16", tags=("",)) -> str:
    rows = []
    header = ("| arch | shape | compute_s | memory_s | collective_s | dominant "
              "| useful | roofline | HBM/dev GB |\n"
              "|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r["mesh"] != mesh or r.get("tag", "") not in tags:
            continue
        x = r["roofline"]
        mem = (r["memory"]["temp_bytes_per_device"]
               + r["memory"]["argument_bytes_per_device"]
               + r["memory"].get("alias_bytes", 0) // r["chips"]) / 1e9
        rows.append(
            f"| {r['arch']} | {r['shape']} | {x['compute_s']:.3g} | "
            f"{x['memory_s']:.3g} | {x['collective_s']:.3g} | {x['dominant']} | "
            f"{x['useful_fraction']:.2f} | {x['roofline_fraction']:.3f} | "
            f"{mem:.2f} |")
    return "\n".join([header] + rows)


def worst_cells(recs, mesh="16x16", k=5):
    cells = [r for r in recs if r["mesh"] == mesh and not r.get("tag")]
    cells.sort(key=lambda r: r["roofline"]["roofline_fraction"])
    return [(r["arch"], r["shape"], r["roofline"]["roofline_fraction"],
             r["roofline"]["dominant"]) for r in cells[:k]]


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    recs = load(out_dir)
    for mesh in ("16x16", "2x16x16"):
        n = sum(r["mesh"] == mesh for r in recs)
        print(f"\n## mesh {mesh} ({n} cells)\n")
        print(table(recs, mesh))
    print("\nworst roofline fractions (16x16):")
    for arch, shape, frac, dom in worst_cells(recs):
        print(f"  {arch} {shape}: {frac:.3f} ({dom}-bound)")
    doms = {}
    for r in recs:
        doms[r["roofline"]["dominant"]] = doms.get(r["roofline"]["dominant"], 0) + 1
    print("\ndominant-term histogram:", doms)


if __name__ == "__main__":
    main()
