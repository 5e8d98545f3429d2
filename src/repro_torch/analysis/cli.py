"""Sweep the benchmark matrix zoo through the plan sanitizer.

    python -m repro_torch.analysis.cli [--matrices rajat12_like,grid64]
                                       [--scale 1.0] [--engines gp,vectorized]
                                       [--variants default,nodense,noflat,allflat]
                                       [--level full] [--reach-trials 8]
                                       [--seed 0] [--device cuda]

Builds every (matrix, symbolic engine, executor variant) combination and
runs :func:`repro_torch.analysis.verify_glu` on it, with the JAX package's
preprocessing (zero-free diagonal + fill-reducing ordering), so the
verified plans are the plans the benchmarks execute.  The variants are the
executor's schedules: ``default``, ``nodense`` (``dense_tail=False``),
``noflat`` (``disable_modes=("flat",)``: flat levels join the K1 runs) and
``allflat`` (``mode_override="flat"``: no K1 level).  ``--device`` is the
card by default, as for every entry point; ``cpu`` runs everything but the
graph audit, which is then reported as not run.  Exits 1 if any case
reports a violation.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# (name, scale factor): the JAX package's zoo
ZOO = [
    ("rajat12_like", 1.0),
    ("circuit_2_like", 0.5),
    ("grid64", 0.5),
    ("memplus_like", 0.1),
    ("asic_like_10k", 0.15),
]

# executor variants: GLU options and the factorizer's disable_modes
VARIANTS = {
    "default": ({}, ()),
    "nodense": ({"dense_tail": False}, ()),
    "noflat": ({}, ("flat",)),
    "allflat": ({"mode_override": "flat"}, ()),
}


def zoo_matrix(name: str, scale: float):
    """One suite matrix after the paper's Fig. 5 preprocessing."""
    from repro_torch.core import fill_reducing_ordering, zero_free_diagonal
    from repro_torch.sparse import make_suite_matrix

    A = make_suite_matrix(name, scale=scale)
    rp = zero_free_diagonal(A)
    A = A.permute(rp, np.arange(A.n, dtype=np.int64))
    perm = fill_reducing_ordering(A, "auto")
    return A.permute(perm, perm)


def build_case(A, engine: str, variant: str, device):
    """The variant's ``GLU`` (``verify="off"``); ``disable_modes`` is the
    factorizer's option alone, so that variant swaps in a factorizer."""
    from repro_torch.core import GLU, TorchFactorizer

    opts, disabled = VARIANTS[variant]
    glu = GLU(A, symbolic=engine, device=device, **opts)
    if disabled:
        glu._factorizer = TorchFactorizer(glu.plan, dtype=glu.dtype,
                                          device=glu.device,
                                          disable_modes=disabled)
    return glu


def run_case(A, engine: str, variant: str, *, level: str,
             reach_trials: int, seed: int, device=None):
    from repro_torch.analysis import verify_glu

    glu = build_case(A, engine, variant, device)
    return verify_glu(glu, level, reach_trials=reach_trials, seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--matrices", default=",".join(n for n, _ in ZOO),
                    help="comma-separated zoo names (default: all)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="extra scale multiplier on the zoo sizes")
    ap.add_argument("--engines", default="gp,vectorized",
                    help="comma-separated symbolic engines")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated executor variants of {list(VARIANTS)}")
    ap.add_argument("--level", choices=("plan", "full"), default="full")
    ap.add_argument("--reach-trials", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    names = [s for s in args.matrices.split(",") if s]
    engines = [s for s in args.engines.split(",") if s]
    variants = [s for s in args.variants.split(",") if s]
    for v in variants:
        if v not in VARIANTS:
            ap.error(f"unknown variant {v!r}; pick from {list(VARIANTS)}")
    scales = dict(ZOO)

    n_bad = 0
    for name in names:
        if name not in scales:
            ap.error(f"unknown zoo matrix {name!r}; pick from "
                     f"{[n for n, _ in ZOO]}")
        A = zoo_matrix(name, scales[name] * args.scale)
        for engine in engines:
            for variant in variants:
                t0 = time.perf_counter()
                rep = run_case(A, engine, variant, level=args.level,
                               reach_trials=args.reach_trials, seed=args.seed,
                               device=args.device)
                dt = time.perf_counter() - t0
                tag = f"{name}(n={A.n}) {engine}/{variant}"
                skipped = (f", not run: {sorted(rep.skipped)}"
                           if rep.skipped else "")
                if rep.ok:
                    print(f"OK   {tag}: {len(rep.checks)} checks{skipped} "
                          f"[{dt:.1f}s]", flush=True)
                else:
                    n_bad += 1
                    print(f"FAIL {tag}: {sorted(rep.codes)} [{dt:.1f}s]",
                          flush=True)
                    for v in rep.violations[:5]:
                        print(f"     {v}", flush=True)
    if n_bad:
        print(f"{n_bad} case(s) FAILED verification", flush=True)
        return 1
    print("all cases verified", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
