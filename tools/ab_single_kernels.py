"""Time the single-matrix kernels of two source trees on one NVIDIA GPU, in
turns, to see what a change to the kernels costs the path that does not
use it.

    python3 tools/ab_single_kernels.py PARENT_TREE CHANGE_TREE

Each tree is a checkout holding ``src/repro_torch``.  The trees run in the
order parent, change, change, parent, each in a fresh process that builds
its own kernels (``<tree>/build/torch_kernels``) and times, with CUDA
events over 50 launches after a warm-up: K1 ``level_run`` on grid64's real
run (``GLU(make_suite_matrix("grid64"))``, the values just before the run)
and on a synthetic run at rajat12_like's level shapes (D 801, R 2,355,
C 794), K1's robust instantiation on grid64's run, K2 at N = 160 and 736
and K3 at N = 736 (float64).  It prints one JSON line per process and a
table of medians per tree.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# one process: time the kernels of the tree on sys.path
CHILD = r'''
import json, sys
import numpy as np, torch
from repro_torch import GLU
from repro_torch.kernels import dense_lu, dense_lu_planar, level_run
from repro_torch.kernels.level_update import random_level_run
from repro_torch.sparse import make_suite_matrix
import repro_torch.core.factorize as fmod

dev = torch.device("cuda")

def ms(fn, reps=50):
    fn(); torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

def k1_input(g):
    """grid64's value array just before its K1 run, and the run."""
    fz = g._factorizer
    vals = torch.zeros(fz.nnz + 1, dtype=fz.dtype, device=dev)
    vals[fz._a_scatter] = torch.as_tensor(np.asarray(g._A_perm.data), device=dev)
    for gr in fz._groups:
        if gr.kind == "run":
            return vals, gr.arrays[0]
        fz._step[gr.kind](vals, *gr.arrays)

out = {}
g = GLU(make_suite_matrix("grid64", 1.0), jit_schedule=False)
v0, run = k1_input(g)
buf = v0.clone()
copy = ms(lambda: buf.copy_(v0))
out["k1_grid64"] = ms(lambda: (buf.copy_(v0), level_run(buf, run))) - copy
tau = torch.tensor(1e-10, dtype=torch.float64, device=dev)
cnt = torch.zeros((), dtype=torch.int32, device=dev)
out["k1_robust_grid64"] = ms(lambda: (buf.copy_(v0), cnt.zero_(),
                                      level_run(buf, run, tau, cnt))) - copy
rrun, rv = random_level_run(np.random.default_rng(0),
                            [(801, 2355, 794), (723, 1200, 794)],
                            torch.float64, dev)
rbuf = rv.clone()
rcopy = ms(lambda: rbuf.copy_(rv))
out["k1_rajat12_shapes"] = ms(lambda: (rbuf.copy_(rv), level_run(rbuf, rrun))) - rcopy
rng = np.random.default_rng(1)
for N in (160, 736):
    a = torch.from_numpy(rng.normal(size=(N, N)) + N * np.eye(N)).to(dev)
    out[f"k2_{N}"] = ms(lambda: dense_lu(a))
p = rng.normal(size=(2, 736, 736)); p[0] += 736 * np.eye(736)
p = torch.from_numpy(p).to(dev)
out["k3_736"] = ms(lambda: dense_lu_planar(p))
print(json.dumps(out))
'''


def run_tree(tree: Path, child: str = CHILD) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"),
               REPRO_TORCH_BUILD_DIR=str(tree / "build" / "torch_kernels"))
    r = subprocess.run([sys.executable, "-c", child], env=env, cwd=tree,
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"{tree}: rc {r.returncode}\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(child: str = CHILD, doc: str = __doc__) -> int:
    """Run ``child`` in the trees of ``sys.argv`` in turns and print the
    table of its numbers."""
    if len(sys.argv) != 3:
        print(doc, file=sys.stderr)
        return 2
    parent, change = (Path(a).resolve() for a in sys.argv[1:])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    results = {"parent": [], "change": []}
    for label, tree in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        res = run_tree(tree, child)
        results[label].append(res)
        print(json.dumps({"tree": label, "ms": res}))
    print(f"{'key':<20} {'parent':>22} {'change':>22}")
    for key in results["parent"][0]:
        p = [r[key] for r in results["parent"]]
        c = [r[key] for r in results["change"]]
        print(f"{key:<20} {' / '.join(f'{v:.4f}' for v in p):>22} "
              f"{' / '.join(f'{v:.4f}' for v in c):>22}  "
              f"change/parent {statistics.mean(c) / statistics.mean(p):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
