#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

 1. the card's name and power limit (``nvidia-smi``);
 2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
 3. each kernel against its plain PyTorch version at the main path's
    shapes, float64 and float32, with the stated tolerances;
 4. for each matrix (grid64, then rajat12_like, both at scale 1.0): plan on
    the host, build ``GLU(A)`` on the card and drive the main path
    (factorize + solve) with every launch counter set to 0 just before and
    read just after: each K1/K2 launch count must equal the schedule's
    count of K1 and dense groups;
 5. five refactorizations with fresh values (a Newton-like perturbation from
    a numpy seed), each solved with ``residual < 1e-9``, and two
    factorizations of the same values that must be bit-identical;
 6. timings with CUDA events after warm-up: factorization and solve, and
    each kernel, its plain version and a one-call library yardstick
    replayed on the exact inputs the main path gave the kernel; bounds from
    the bytes and operations of those inputs; peak device memory; kernel
    launches and device-busy share per factorization and per solve
    (torch.profiler), beside this host's cost of one small op.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the FP64 tensor /
# FP32 non-tensor rates.  Bounds below are stated against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}

K1_TOL = {"float32": 1e-5, "float64": 1e-12}
K2_TOL = {"float32": 5e-3, "float64": 1e-9}
# K2's componentwise backward error max |LU - A| / (|L| |U|), in units of
# N times the dtype's epsilon: catches a wrong L whose entries lie below
# K2_TOL (on the test tiles they are about 1/N)
K2_BWD = 4.0

# (suite name, scale, expected K1 launches, expected K2 launches) per
# factorization; the counts are the schedules' own, checked again here
MATRICES = [("grid64", 1.0, 154, 1), ("rajat12_like", 1.0, 10, 1)]
N_REFACTOR = 5
SEED = 1234


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def compare(got, want, tol: float) -> float:
    """Assert kernel == plain version within ``tol`` (NaN where the plain
    version has NaN: main-path inputs read the trash slot at padded
    positions) and return the largest absolute difference elsewhere."""
    torch.testing.assert_close(got, want, rtol=tol, atol=tol, equal_nan=True)
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return (got[fin] - want[fin]).abs().max().item()


class Clock:
    """Device time with CUDA events: ``ms(fn, reps)`` is the mean time of
    one ``fn()`` over ``reps`` back-to-back calls after one warm-up call."""

    def __init__(self, device):
        self.device = device

    def ms(self, fn, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(stop) / reps

    def median_ms(self, fn, reps: int = 7) -> float:
        """Median of single-call times (host clock around a synchronised
        call): the time a caller waits for one call."""
        fn()
        torch.cuda.synchronize(self.device)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(self.device)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)


def check_kernels_at_shapes(dev) -> None:
    """Phase 3: kernel against plain version on random inputs at the main
    path's shapes (grid64: K1 (D, R, C) up to (905, 90, 297),
    (710, 135, 297) and (392, 199, 297), K2 N=160; rajat12_like: K1 about (728, 1280, 1024), K2
    N=736; and the K2 maximum N=1024).  K2 is also held to its backward
    error, which a wrong L cannot pass."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    rng = np.random.default_rng(SEED)
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for D, R, C in [(905, 90, 297), (710, 135, 297), (392, 199, 297),
                        (17, 90, 288), (1, 90, 270), (728, 1280, 1024)]:
            cv = torch.from_numpy(rng.normal(size=(D, C))).to(dev, dtype)
            cb = torch.from_numpy(rng.normal(size=(D, R))).to(dev, dtype)
            dl = torch.from_numpy(rng.integers(0, C + 64, size=(D, R))
                                  .astype("int32")).to(dev)
            got = kernels.segmented_accumulate(cv, cb, dl)
            torch.cuda.synchronize(dev)
            want = ref.segmented_accumulate_ref(cv, cb, dl)
            torch.cuda.synchronize(dev)
            err = compare(got, want, K1_TOL[name])
            log(f"check K1 {name} D={D} R={R} C={C}: max_abs_err={err:.3e} "
                f"tol={K1_TOL[name]:g} ok")
        dup = kernels.segmented_accumulate(
            torch.zeros((2, 128), dtype=dtype, device=dev),
            torch.ones((2, 512), dtype=dtype, device=dev),
            torch.zeros((2, 512), dtype=torch.int32, device=dev))
        torch.cuda.synchronize(dev)
        assert bool((dup[:, 0] == 512).all()) and bool((dup[:, 1:] == 0).all())
        log(f"check K1 {name} all-duplicate positions: ok")
        for N in (160, 736, 1024):
            a = torch.from_numpy(rng.normal(size=(N, N))).to(dev, dtype)
            a += N * torch.eye(N, dtype=dtype, device=dev)
            got = kernels.dense_lu(a)
            torch.cuda.synchronize(dev)
            want = ref.dense_lu_ref(a)
            torch.cuda.synchronize(dev)
            err = compare(got, want, K2_TOL[name])
            bwd = ref.lu_backward_error(a, got)
            bwd_tol = K2_BWD * N * torch.finfo(dtype).eps
            assert bwd <= bwd_tol, (name, N, bwd, bwd_tol)
            log(f"check K2 {name} N={N}: max_abs_err={err:.3e} "
                f"tol={K2_TOL[name]:g}; backward error {bwd:.3e} <= "
                f"{bwd_tol:.3e} ok")


def newton_values(A, rng):
    """A Newton-like iterate on A's pattern: off-diagonal conductances move
    by up to 10%, diagonals grow by 10-20% (diagonal dominance holds)."""
    cols = np.repeat(np.arange(A.n), np.diff(A.indptr))
    diag = A.indices == cols
    scale = np.where(diag, rng.uniform(1.1, 1.2, size=A.nnz),
                     rng.uniform(0.9, 1.1, size=A.nnz))
    return np.asarray(A.data) * scale


def drive_matrix(dev, clock, name, scale, want_k1, want_k2):
    """Phases 4-6 for one matrix.  Returns the matrix's report and the
    kernels' inputs recorded from one factorization."""
    import repro_torch.core.factorize as factorize_mod
    import repro_torch.kernels.ops as ops_mod
    from repro_torch import GLU
    from repro_torch.core import plan_factorization
    from repro_torch.kernels import dense_lu, segmented_accumulate
    from repro_torch.sparse import make_suite_matrix

    A = make_suite_matrix(name, scale)
    t0 = time.perf_counter()
    plan_factorization(A)             # fills the process-wide plan cache
    plan_s = time.perf_counter() - t0
    log(f"{name}: n={A.n} nnz={A.nnz} planning {plan_s:.3f} s (host numpy)")
    rng = np.random.default_rng(SEED)
    b = rng.normal(size=A.n)

    # -- the main path: counters at 0 just before, read just after ----------
    segmented_accumulate.launches = 0
    dense_lu.launches = 0
    t0 = time.perf_counter()
    g = GLU(A)
    build_s = time.perf_counter() - t0
    g.factorize()
    x = g.solve(b)
    torch.cuda.synchronize(dev)
    k1, k2 = segmented_accumulate.launches, dense_lu.launches
    kinds = g._factorizer.kinds
    info = g.solve_info
    # real work of the K1 and K2 steps, for the bounds: updates and
    # destination slots that are not padding, and the tail's real size
    nnz = g._factorizer.nnz
    k1_groups = [gr.arrays for gr in g._factorizer._groups
                 if gr.kind == "pallas"]
    work = dict(
        k1_real_updates=sum(int((a[2] < nnz).sum()) for a in k1_groups),
        k1_real_slots=sum(int((a[5] < nnz).sum()) for a in k1_groups),
        k1_padded_updates=sum(a[2].numel() for a in k1_groups),
        k1_padded_slots=sum(a[5].numel() for a in k1_groups),
        k2_sizes=[g._factorizer.dense_tail_info["size"]]
        if g._factorizer.dense_tail_info else [])
    log(f"{name}: main path K1 launches={k1} (K1 groups {kinds.count('pallas')}, "
        f"expected {want_k1}), K2 launches={k2} (dense groups "
        f"{kinds.count('dense')}, expected {want_k2}), groups={len(kinds)}, "
        f"levels={g.num_levels}, nnz_filled={g.nnz_filled}, "
        f"dense_tail={g._factorizer.dense_tail_info}")
    assert k1 == kinds.count("pallas") == want_k1, (k1, want_k1)
    assert k2 == kinds.count("dense") == want_k2, (k2, want_k2)
    assert info["kernels_disabled_reason"] is None, info
    res0 = g.residual(b, x)
    assert np.isfinite(x).all() and x.shape == (A.n,) and res0 < 1e-9, res0
    log(f"{name}: solve residual={res0:.3e}; GLU build {build_s:.3f} s")

    # -- refactorizations with fresh values ----------------------------------
    S = A.to_scipy()
    vals_set = [newton_values(A, rng) for _ in range(N_REFACTOR)]
    for i, new in enumerate(vals_set):
        x = g.factorize(new).solve(b)
        S.data = new
        res = float(np.abs(S @ x - b).max() / np.abs(b).max())
        assert np.isfinite(x).all() and res < 1e-9, (i, res)
        log(f"{name}: refactorization {i}: residual={res:.3e} < 1e-9 ok")
    x2 = g.solve(b, refine=2)
    rinfo = g.solve_info
    assert rinfo["converged"], rinfo
    log(f"{name}: refine=2 backward_error={rinfo['backward_error']:.3e} "
        f"iters={rinfo['refine_iters']} residual="
        f"{float(np.abs(S @ x2 - b).max() / np.abs(b).max()):.3e}")

    # -- bit-identical repeat ---------------------------------------------------
    v1 = g.factorize(vals_set[0]).factorized_values().clone()
    v2 = g.factorize(vals_set[0]).factorized_values()
    x1 = g.solve(b)
    x2 = g.solve(b)
    assert torch.equal(v1, v2) and np.array_equal(x1, x2)
    log(f"{name}: two factorizations and solves of the same values are "
        "bit-identical")

    # -- record the kernels' inputs from one factorization ------------------
    rec_k1, rec_k2 = [], []
    real_k1, real_k2 = ops_mod.segmented_accumulate, factorize_mod.dense_lu

    def k1_recorder(cv, cb, dl):
        rec_k1.append((cv.clone(), cb.clone(), dl.clone()))
        return real_k1(cv, cb, dl)

    def k2_recorder(a):
        rec_k2.append(a.clone())
        return real_k2(a)

    ops_mod.segmented_accumulate = k1_recorder
    factorize_mod.dense_lu = k2_recorder
    try:
        g.factorize(vals_set[0])
    finally:
        ops_mod.segmented_accumulate = real_k1
        factorize_mod.dense_lu = real_k2
    torch.cuda.synchronize(dev)

    # -- timings ----------------------------------------------------------------
    a_dev = g._a_vals
    bp = torch.as_tensor((b * g.Dr)[g._inv_row], dtype=g.dtype, device=dev)
    fact_ms = clock.ms(lambda: g._factorizer.factorize(a_dev), reps=10)
    solve_ms = clock.ms(lambda: g._solver.solve(g._vals, bp), reps=10)
    fact_call_ms = clock.median_ms(lambda: g.factorize(vals_set[1]))
    solve_call_ms = clock.median_ms(lambda: g.solve(b))
    report = dict(
        matrix=name, scale=scale, n=A.n, nnz=A.nnz, nnz_filled=g.nnz_filled,
        levels=g.num_levels, groups=len(kinds), planning_s=plan_s,
        glu_build_s=build_s, k1_launches=k1, k2_launches=k2,
        factorize_steps=info["n_dispatches"],
        solve_steps=g._solver.last_n_dispatches,
        factorize_ms=fact_ms, solve_ms=solve_ms,
        factorize_call_ms=fact_call_ms, solve_call_ms=solve_call_ms,
        refactor_residual_max="< 1e-9", **work)
    log(f"{name}: factorize {fact_ms:.3f} ms (device values, CUDA events), "
        f"solve {solve_ms:.3f} ms; GLU.factorize call median {fact_call_ms:.3f} ms, "
        f"GLU.solve call median {solve_call_ms:.3f} ms")
    return report, rec_k1, rec_k2, g


def kernel_entries(dev, clock, rec_k1, rec_k2, report):
    """Time each kernel, its plain version and the library yardstick on the
    recorded main-path inputs; compute bounds from the real (unpadded)
    work of those inputs."""
    from repro_torch.kernels import dense_lu, segmented_accumulate
    from repro_torch.kernels.ref import (
        dense_lu_ref,
        lu_backward_error,
        segmented_accumulate_ref,
    )

    # K1 over every K1 call of one factorization
    err = 0.0
    for cv, cb, dl in rec_k1:
        err = max(err, compare(segmented_accumulate(cv, cb, dl),
                               segmented_accumulate_ref(cv, cb, dl),
                               K1_TOL[str(cv.dtype).split(".")[-1]]))
    # each real slot read and written once, each real contribution and its
    # int32 position read once; one add per real contribution
    esize = rec_k1[0][0].element_size()
    k1_bytes = (2 * report["k1_real_slots"] * esize
                + report["k1_real_updates"] * (esize + 4))
    k1_ops = report["k1_real_updates"]
    k1_t_bytes = k1_bytes / PEAK_BYTES_PER_S * 1e3
    k1_t_ops = k1_ops / PEAK_OPS_PER_S["float64"] * 1e3
    # library yardstick: one scatter_add_ per call into a prepared (D, C+1)
    # buffer whose last column collects the padding
    lib_in = []
    for cv, cb, dl in rec_k1:
        D, C = cv.shape
        buf = torch.zeros((D, C + 1), dtype=cv.dtype, device=dev)
        buf[:, :C] = cv
        idx = torch.where((dl >= 0) & (dl < C), dl, C).long()
        lib_in.append((buf, idx, cb))

    def run_k1():
        for cv, cb, dl in rec_k1:
            segmented_accumulate(cv, cb, dl)

    def run_k1_plain():
        for cv, cb, dl in rec_k1:
            segmented_accumulate_ref(cv, cb, dl)

    def run_k1_lib():
        for buf, idx, cb in lib_in:
            buf.scatter_add_(1, idx, cb)

    k1 = dict(name="segmented_accumulate", route="cuda",
              source="src/repro_torch/kernels/csrc/segmented_accumulate.cu",
              replaces="src/repro/kernels/level_update.py:60",
              launches=report["k1_launches"], max_abs_err=err,
              ms=clock.ms(run_k1), plain_ms=clock.ms(run_k1_plain, reps=3),
              bound_ms=max(k1_t_bytes, k1_t_ops),
              bound_by="bytes" if k1_t_bytes >= k1_t_ops else "operations",
              library_ms=clock.ms(run_k1_lib))
    k1["per_launch_us"] = k1["ms"] * 1e3 / max(1, len(rec_k1))
    k1["calls_timed"] = len(rec_k1)

    # K2 on the recorded dense tail tile(s)
    err = 0.0
    for a in rec_k2:
        got = dense_lu(a)
        err = max(err, compare(got, dense_lu_ref(a),
                               K2_TOL[str(a.dtype).split(".")[-1]]))
        bwd = lu_backward_error(a, got)
        bwd_tol = K2_BWD * a.shape[0] * torch.finfo(a.dtype).eps
        assert bwd <= bwd_tol, ("main-path K2", bwd, bwd_tol)
    # the real tail, not its padding to K2's block
    esize = rec_k2[0].element_size()
    k2_bytes = sum(2 * m * m * esize for m in report["k2_sizes"])
    k2_ops = sum(2 * m ** 3 / 3 for m in report["k2_sizes"])
    k2_t_bytes = k2_bytes / PEAK_BYTES_PER_S * 1e3
    k2_t_ops = k2_ops / PEAK_OPS_PER_S["float64"] * 1e3

    def run_k2():
        for a in rec_k2:
            dense_lu(a)

    def run_k2_plain():
        for a in rec_k2:
            dense_lu_ref(a)

    def run_k2_lib():
        for a in rec_k2:
            torch.linalg.lu_factor(a, pivot=False)

    k2 = dict(name="dense_lu", route="cuda",
              source="src/repro_torch/kernels/csrc/dense_lu.cu",
              replaces="src/repro/kernels/dense_lu.py:98",
              launches=report["k2_launches"], max_abs_err=err,
              ms=clock.ms(run_k2), plain_ms=clock.ms(run_k2_plain, reps=3),
              bound_ms=max(k2_t_bytes, k2_t_ops),
              bound_by="bytes" if k2_t_bytes >= k2_t_ops else "operations",
              library_ms=clock.ms(run_k2_lib))
    k2["N"] = [int(a.shape[0]) for a in rec_k2]
    return [k1, k2]


def _profile(dev, fn):
    """Kernel launches and device-side time of one ``fn()`` call, from
    torch.profiler; 'not measured' when it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    rows = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue                  # host ops: their kernels are listed too
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us, evt.key, evt.count))
    if not rows:
        return {"profiler": "not measured (no device time recorded)"}
    rows.sort(reverse=True)
    return {"kernels": sum(r[2] for r in rows),
            "device_busy_ms": sum(r[0] for r in rows) / 1e3,
            "top": [{"name": k[:70], "device_ms": t / 1e3, "count": c}
                    for t, k, c in rows[:6]]}


def profile_path(dev, clock, g):
    """Device kernels and device-busy time per factorization and per solve,
    and this host's cost of one small PyTorch op on the card (the unit the
    eager schedule pays per launch).  Busy share = device-busy time over
    the CUDA-event time of the same call."""
    b = torch.ones(g.n, dtype=g.dtype, device=dev)
    y = torch.zeros(8, dtype=g.dtype, device=dev)
    out = {"host_op_us": clock.ms(lambda: [y.add_(1.0) for _ in range(1000)],
                                  reps=3)}
    for name, fn in (("factorize", lambda: g._factorizer.factorize(g._a_vals)),
                     ("solve", lambda: g._solver.solve(g._vals, b))):
        prof = _profile(dev, fn)
        if "device_busy_ms" in prof:
            prof["event_ms"] = clock.ms(fn, reps=5)
            prof["device_busy_share"] = prof["device_busy_ms"] / prof["event_ms"]
        out[name] = prof
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the package is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. the card
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(cached={_build.build_info.get('cached')}) -> {_build.build_info['path']}")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")

    # 3. kernels against their plain versions
    check_kernels_at_shapes(dev)

    # 4-6. the main path per matrix
    clock = Clock(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    entries = None
    for name, scale, want_k1, want_k2 in MATRICES:
        report, rec_k1, rec_k2, g = drive_matrix(dev, clock, name, scale,
                                                 want_k1, want_k2)
        ents = kernel_entries(dev, clock, rec_k1, rec_k2, report)
        report["kernels"] = ents
        report["profile"] = profile_path(dev, clock, g)
        if entries is None:           # the first matrix is the slice's main path
            entries = ents
        log(json.dumps({"matrix_report": report}))
        del rec_k1, rec_k2, g
    log(f"peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(f"card: {card}")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
