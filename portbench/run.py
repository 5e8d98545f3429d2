"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
as the last line of standard output.

  python3 portbench/run.py --workload grid128.newton --seed 7 --seconds 20 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch.  Every run judges the answers
of its window against the plain reference (``correct``) and prints each
number compared beside its limit, last on standard error and last in the
result line.  Exits with 2, printing no result, without a card or with
fewer cards than the cell asks for, and with 3 if JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the port's kernel build cache: a fixed directory inside the checkout,
    # so only a checkout's first run builds
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "torch_kernels")
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from portbench.harness import Bench, forbidden_modules, run_cell

    bench = Bench(ROOT)
    need = int(bench.cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (JAX or the JAX package)", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
