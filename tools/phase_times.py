"""Run a tree's ``chip_smoke.py`` with each of its phase functions timed on
the host's clock, to see where the script's time goes.

    python3 tools/phase_times.py [--log-dir DIR] TREE [TREE ...]

Each TREE is a directory holding ``chip_smoke.py`` and ``src/``.  For each,
in turn and in a fresh process, the script's module-level functions whose
names start with ``drive_`` or ``check_`` (its phases), and
``kernel_entries``, ``profile_path``, ``_profile`` and the ``*_entry``
helpers (the measurements of phases 4-6 and 9-10), are wrapped in a timer,
and its ``main()`` runs as
``python3 chip_smoke.py`` would run it, with its output sent to
``DIR/phase_times_<i>.log`` (default ``build/phase_times``).  The last
line printed is one JSON object: per tree, its exit code, its total
seconds and the seconds of each function's calls, in call order.
``--stop-before NAME`` ends each script when it first calls the function
NAME (``drive_lm_serve`` times phases 1-16 alone).  Trees
run one after the other on one card, so a parent and a change compare
within one call.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import contextlib, functools, importlib.util, json, sys, time
from pathlib import Path

tree = Path(sys.argv[1]).resolve()
stop_before = sys.argv[3] if len(sys.argv) > 3 else None
spec = importlib.util.spec_from_file_location("chip_smoke", tree / "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
seconds = {}

class Stop(Exception):
    pass

def stop(*args, **kwargs):
    raise Stop(stop_before)

def timed(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.setdefault(name, []).append(time.perf_counter() - t0)
    return wrapper

for name, fn in list(vars(smoke).items()):
    if callable(fn) and getattr(fn, "__module__", None) == "chip_smoke" and (
            name.startswith(("drive_", "check_"))
            or name.endswith("_entry")
            or name in ("kernel_entries", "profile_path", "_profile")):
        setattr(smoke, name, timed(name, fn))
if stop_before:
    setattr(smoke, stop_before, stop)
t0 = time.perf_counter()
with open(sys.argv[2], "w") as log, contextlib.redirect_stdout(log):
    try:
        rc = smoke.main()
    except Stop as exc:
        print(f"stopped before {exc}", flush=True)
        rc = 0
    except BaseException as exc:
        print(f"main raised {exc!r}", flush=True)
        rc = 1
print(json.dumps({"rc": rc, "total_s": time.perf_counter() - t0,
                  "seconds": seconds}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description="time each phase of chip_smoke.py")
    ap.add_argument("--log-dir", type=Path,
                    default=Path(__file__).resolve().parent.parent / "build" / "phase_times")
    ap.add_argument("--stop-before", default=None,
                    help="end each script where it first calls this function")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    trees, out_dir = args.trees, args.log_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    results = {}
    for i, tree in enumerate(trees):
        log = out_dir / f"phase_times_{i}.log"
        argv = [tree, str(log)] + ([args.stop_before] if args.stop_before else [])
        proc = subprocess.run([sys.executable, "-c", CHILD, *argv],
                              cwd=tree, capture_output=True, text=True)
        print(proc.stderr[-2000:], file=sys.stderr)
        lines = proc.stdout.strip().splitlines()
        results[tree] = json.loads(lines[-1]) if lines else {"rc": proc.returncode}
        print(f"{tree}: {json.dumps(results[tree])}", flush=True)
    print(json.dumps({"phase_times": results}))
    return 0 if all(r.get("rc") == 0 for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
