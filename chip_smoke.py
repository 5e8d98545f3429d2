#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

 1. the card's name and power limit (``nvidia-smi``);
 2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
 3. each kernel against its plain PyTorch version at the main path's
    shapes, float64 and float32 (complex128 and complex64 planes for K3),
    with the stated tolerances; K2 and K3 also against their componentwise
    backward error;
 4. for each matrix (grid64 and rajat12_like, real, at scale 1.0; then
    rajat12_ac, the complex AC matrix ``G + jwC`` on rajat12_like's
    pattern): plan on the host, build ``GLU(A)`` on the card and drive the
    path (factorize + solve) with every launch counter set to 0 just before
    and read just after: the K1, K2 and K3 launch counts must equal the
    schedule's count of K1 and dense groups;
 5. refactorizations with fresh values (real matrices: a Newton-like
    perturbation from a numpy seed; rajat12_ac: other frequencies in a
    decade around 1e3 rad/s), each solved with ``residual < 1e-9``, a
    refined solve that converges, and two factorizations and solves of the
    same values that must be bit-identical;
 6. timings with CUDA events after warm-up: factorization and solve, and
    each kernel, its plain version and a one-call library yardstick
    replayed on the exact inputs the main path gave the kernel; bounds from
    the bytes and operations of those inputs; peak device memory; kernel
    launches and device-busy share per factorization and per solve
    (torch.profiler), beside this host's cost of one small op.

The line before the last is ``{"kernels": [...]}``, one entry per kernel
and matrix, over all matrices; the last line is
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
K2_TOL = {"float32": 5e-3, "float64": 1e-9}   # K3 too, on its planes
# K2's and K3's componentwise backward error max |LU - A| / (|L| |U|), in
# units of N times the plane dtype's epsilon: catches a wrong L whose
# entries lie below K2_TOL (on the test tiles they are about 1/N)
K2_BWD = 4.0

# (matrix, expected K1, K2 and K3 launches per factorization); the counts
# are the schedules' own, checked again here.  rajat12_ac is
# ac_jacobian(1879, avg_degree=6.9, seed=0): rajat12_like's exact pattern
# with complex values, so it plans into the same schedule
MATRICES = [("grid64", 154, 1, 0), ("rajat12_like", 10, 1, 0),
            ("rajat12_ac", 10, 0, 1)]
N_REFACTOR = 5
AC_OMEGAS = np.logspace(2.5, 3.5, N_REFACTOR)   # rad/s, around the plan's 1e3
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
    (710, 135, 297) and (392, 199, 297), K2 N=160; rajat12_like: K1 about
    (728, 1280, 1024), K2 N=736; rajat12_ac: K1 on (2·728, 1280) planes,
    K3 N=736; K3 also at N=96, and K2's and K3's maximum N=1024).  K2 and
    K3 are also held to their backward error, which a wrong L cannot
    pass."""
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
        for N in (96, 736, 1024):
            a = torch.from_numpy(rng.normal(size=(2, N, N))).to(dev, dtype)
            a[0] += N * torch.eye(N, dtype=dtype, device=dev)
            got = kernels.dense_lu_planar(a)
            torch.cuda.synchronize(dev)
            want = ref.dense_lu_planar_ref(a)
            torch.cuda.synchronize(dev)
            err = compare(got, want, K2_TOL[name])
            bwd = ref.lu_backward_error(a, got)
            bwd_tol = K2_BWD * N * torch.finfo(dtype).eps
            assert bwd <= bwd_tol, ("K3", name, N, bwd, bwd_tol)
            log(f"check K3 {name} planes (complex) N={N}: max_abs_err="
                f"{err:.3e} tol={K2_TOL[name]:g}; complex backward error "
                f"{bwd:.3e} <= {bwd_tol:.3e} ok")


def make_matrix(name):
    from repro_torch.sparse import ac_jacobian, make_suite_matrix

    if name == "rajat12_ac":
        return ac_jacobian(1879, avg_degree=6.9, seed=0)
    return make_suite_matrix(name, 1.0)


def refactor_values(name, A, rng):
    """Values for the refactorizations on A's pattern: other frequencies of
    the AC matrix, Newton-like iterates of a real one."""
    from repro_torch.sparse import ac_jacobian

    if name == "rajat12_ac":
        return [ac_jacobian(1879, omega=w, avg_degree=6.9, seed=0).data
                for w in AC_OMEGAS]
    return [newton_values(A, rng) for _ in range(N_REFACTOR)]


def newton_values(A, rng):
    """A Newton-like iterate on A's pattern: off-diagonal conductances move
    by up to 10%, diagonals grow by 10-20% (diagonal dominance holds)."""
    cols = np.repeat(np.arange(A.n), np.diff(A.indptr))
    diag = A.indices == cols
    scale = np.where(diag, rng.uniform(1.1, 1.2, size=A.nnz),
                     rng.uniform(0.9, 1.1, size=A.nnz))
    return np.asarray(A.data) * scale


def drive_matrix(dev, clock, name, want_k1, want_k2, want_k3):
    """Phases 4-6 for one matrix.  Returns the matrix's report, the GLU and
    the kernels' inputs recorded from one factorization."""
    import repro_torch.core.factorize as factorize_mod
    import repro_torch.kernels.ops as ops_mod
    from repro_torch import GLU
    from repro_torch.core import plan_factorization
    from repro_torch.kernels import (
        dense_lu,
        dense_lu_planar,
        segmented_accumulate,
    )

    A = make_matrix(name)
    cplx = np.iscomplexobj(A.data)
    dtype = torch.complex128 if cplx else torch.float64
    t0 = time.perf_counter()
    # fills the process-wide plan cache; rajat12_ac's MC64 matching equals
    # rajat12_like's, so it reuses that plan, as an AC sweep after a
    # transient run on the same circuit would
    _, _, from_cache = plan_factorization(A)
    plan_s = time.perf_counter() - t0
    log(f"{name}: n={A.n} nnz={A.nnz} {dtype} planning {plan_s:.3f} s "
        f"(host numpy, plan from cache: {from_cache})")
    rng = np.random.default_rng(SEED)
    b = rng.normal(size=A.n)
    if cplx:
        b = b + 1j * rng.normal(size=A.n)

    # -- the path: counters at 0 just before, read just after ---------------
    segmented_accumulate.launches = 0
    dense_lu.launches = 0
    dense_lu_planar.launches = 0
    t0 = time.perf_counter()
    g = GLU(A, dtype=dtype)
    build_s = time.perf_counter() - t0
    g.factorize()
    x = g.solve(b)
    torch.cuda.synchronize(dev)
    k1, k2 = segmented_accumulate.launches, dense_lu.launches
    k3 = dense_lu_planar.launches
    kinds = g._factorizer.kinds
    info = g.solve_info
    # real work of the K1 and dense-tail steps, for the bounds: updates and
    # destination slots that are not padding, and the tail's real size
    nnz = g._factorizer.nnz
    k1_groups = [gr.arrays for gr in g._factorizer._groups
                 if gr.kind == "pallas"]
    work = dict(
        planes=2 if cplx else 1,
        k1_real_updates=sum(int((a[2] < nnz).sum()) for a in k1_groups),
        k1_real_slots=sum(int((a[5] < nnz).sum()) for a in k1_groups),
        k1_padded_updates=sum(a[2].numel() for a in k1_groups),
        k1_padded_slots=sum(a[5].numel() for a in k1_groups),
        tail_sizes=[g._factorizer.dense_tail_info["size"]]
        if g._factorizer.dense_tail_info else [])
    n_dense = kinds.count("dense")
    log(f"{name}: path K1 launches={k1} (K1 groups {kinds.count('pallas')}, "
        f"expected {want_k1}), K2 launches={k2} (expected {want_k2}), K3 "
        f"launches={k3} (expected {want_k3}; dense groups {n_dense}), "
        f"groups={len(kinds)}, levels={g.num_levels}, "
        f"nnz_filled={g.nnz_filled}, layout={info['layout']}, "
        f"dense_tail={g._factorizer.dense_tail_info}")
    assert k1 == kinds.count("pallas") == want_k1, (k1, want_k1)
    assert k2 == want_k2 and k3 == want_k3 and k2 + k3 == n_dense, (k2, k3)
    assert info["kernels_disabled_reason"] is None, info
    assert info["layout"] == ("planar" if cplx else "native"), info
    res0 = g.residual(b, x)
    assert np.isfinite(x).all() and x.shape == (A.n,) and res0 < 1e-9, res0
    log(f"{name}: solve residual={res0:.3e}; GLU build {build_s:.3f} s")

    # -- refactorizations with fresh values ----------------------------------
    S = A.to_scipy()
    vals_set = refactor_values(name, A, rng)
    for i, new in enumerate(vals_set):
        x = g.factorize(new).solve(b)
        S.data = new
        res = float(np.abs(S @ x - b).max() / np.abs(b).max())
        assert np.isfinite(x).all() and res < 1e-9, (i, res)
        log(f"{name}: refactorization {i}: residual={res:.3e} < 1e-9 ok")
    x2 = g.solve(b, refine=2)
    rinfo = g.solve_info
    assert rinfo["converged"] and np.isfinite(x2).all(), rinfo
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
    rec = {"k1": [], "k2": [], "k3": []}
    real = {"k1": ops_mod.segmented_accumulate, "k2": factorize_mod.dense_lu,
            "k3": factorize_mod.dense_lu_planar}

    def k1_recorder(cv, cb, dl):
        rec["k1"].append((cv.clone(), cb.clone(), dl.clone()))
        return real["k1"](cv, cb, dl)

    def tile_recorder(key):
        def record(a):
            rec[key].append(a.clone())
            return real[key](a)
        return record

    ops_mod.segmented_accumulate = k1_recorder
    factorize_mod.dense_lu = tile_recorder("k2")
    factorize_mod.dense_lu_planar = tile_recorder("k3")
    try:
        g.factorize(vals_set[0])
    finally:
        ops_mod.segmented_accumulate = real["k1"]
        factorize_mod.dense_lu = real["k2"]
        factorize_mod.dense_lu_planar = real["k3"]
    torch.cuda.synchronize(dev)

    # -- timings ----------------------------------------------------------------
    a_dev = g._a_vals
    bp = torch.as_tensor((b * g.Dr)[g._inv_row], dtype=g.dtype, device=dev)
    fact_ms = clock.ms(lambda: g._factorizer.factorize(a_dev), reps=10)
    solve_ms = clock.ms(lambda: g._solver.solve(g._vals, bp), reps=10)
    fact_call_ms = clock.median_ms(lambda: g.factorize(vals_set[1]))
    solve_call_ms = clock.median_ms(lambda: g.solve(b))
    report = dict(
        matrix=name, dtype=str(dtype), n=A.n, nnz=A.nnz,
        nnz_filled=g.nnz_filled, levels=g.num_levels, groups=len(kinds),
        planning_s=plan_s, plan_from_cache=from_cache, glu_build_s=build_s,
        k1_launches=k1,
        k2_launches=k2, k3_launches=k3, refine2=dict(
            iters=rinfo["refine_iters"],
            backward_error=rinfo["backward_error"]),
        factorize_steps=info["n_dispatches"],
        solve_steps=g._solver.last_n_dispatches,
        factorize_ms=fact_ms, solve_ms=solve_ms,
        factorize_call_ms=fact_call_ms, solve_call_ms=solve_call_ms,
        refactor_residual_max="< 1e-9", **work)
    log(f"{name}: factorize {fact_ms:.3f} ms (device values, CUDA events), "
        f"solve {solve_ms:.3f} ms; GLU.factorize call median {fact_call_ms:.3f} ms, "
        f"GLU.solve call median {solve_call_ms:.3f} ms")
    return report, rec, g


def _bound(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S["float64"] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_entries(dev, clock, rec, report):
    """Time each kernel the matrix's path ran, its plain version and the
    library yardstick on the recorded path inputs; compute bounds from the
    real (unpadded) work of those inputs."""
    out = []
    if rec["k1"]:
        out.append(_k1_entry(dev, clock, rec["k1"], report))
    if rec["k2"]:
        out.append(_tile_entry(clock, rec["k2"], report, planar=False))
    if rec["k3"]:
        out.append(_tile_entry(clock, rec["k3"], report, planar=True))
    for e in out:
        e["matrix"] = report["matrix"]
    return out


def _k1_entry(dev, clock, rec_k1, report):
    from repro_torch.kernels import segmented_accumulate
    from repro_torch.kernels.ref import segmented_accumulate_ref

    # K1 over every K1 call of one factorization
    err = 0.0
    for cv, cb, dl in rec_k1:
        err = max(err, compare(segmented_accumulate(cv, cb, dl),
                               segmented_accumulate_ref(cv, cb, dl),
                               K1_TOL[str(cv.dtype).split(".")[-1]]))
    # each real slot read and written once, each real contribution and its
    # int32 position read once; one add per real contribution; a complex
    # path folds both planes into K1's rows, so each counts twice
    esize = rec_k1[0][0].element_size()
    planes = report["planes"]
    k1_bytes = planes * (2 * report["k1_real_slots"] * esize
                         + report["k1_real_updates"] * (esize + 4))
    k1_ops = planes * report["k1_real_updates"]
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
              **_bound(k1_bytes, k1_ops),
              library_ms=clock.ms(run_k1_lib))
    k1["per_launch_us"] = k1["ms"] * 1e3 / max(1, len(rec_k1))
    k1["calls_timed"] = len(rec_k1)
    return k1


def _tile_entry(clock, tiles, report, planar: bool):
    """K2 (real (N, N) tiles) or K3 ((2, N, N) complex planes) on the
    recorded dense-tail tile(s)."""
    from repro_torch.kernels import dense_lu, dense_lu_planar
    from repro_torch.kernels.ref import (
        dense_lu_planar_ref,
        dense_lu_ref,
        lu_backward_error,
    )

    kernel = dense_lu_planar if planar else dense_lu
    plain = dense_lu_planar_ref if planar else dense_lu_ref
    err = 0.0
    for a in tiles:
        got = kernel(a)
        err = max(err, compare(got, plain(a),
                               K2_TOL[str(a.dtype).split(".")[-1]]))
        bwd = lu_backward_error(a, got)
        bwd_tol = K2_BWD * a.shape[-1] * torch.finfo(a.dtype).eps
        assert bwd <= bwd_tol, ("path tile", planar, bwd, bwd_tol)
    # the real tail, not its padding to the block: each value read and
    # written once; 2m^3/3 multiply-adds as operations, a complex one being
    # 4 real multiplies and 4 adds (8m^3/3 real operations in all)
    esize = tiles[0].element_size()
    per = 2 if planar else 1
    n_bytes = sum(2 * per * m * m * esize for m in report["tail_sizes"])
    n_ops = sum(per * per * 2 * m ** 3 / 3 for m in report["tail_sizes"])
    # library yardstick: one unpivoted LU call on the same tile, complex
    # for K3 (converted once, outside the timing)
    lib_in = [torch.complex(a[0], a[1]) if planar else a for a in tiles]

    def run():
        for a in tiles:
            kernel(a)

    def run_plain():
        for a in tiles:
            plain(a)

    def run_lib():
        for a in lib_in:
            torch.linalg.lu_factor(a, pivot=False)

    if planar:
        ent = dict(name="dense_lu_planar", route="cuda",
                   source="src/repro_torch/kernels/csrc/dense_lu_planar.cu",
                   replaces="src/repro/kernels/dense_lu.py:207",
                   launches=report["k3_launches"])
    else:
        ent = dict(name="dense_lu", route="cuda",
                   source="src/repro_torch/kernels/csrc/dense_lu.cu",
                   replaces="src/repro/kernels/dense_lu.py:98",
                   launches=report["k2_launches"])
    ent.update(max_abs_err=err, ms=clock.ms(run),
               plain_ms=clock.ms(run_plain, reps=3), **_bound(n_bytes, n_ops),
               library_ms=clock.ms(run_lib))
    ent["N"] = [int(a.shape[-1]) for a in tiles]
    return ent


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
    entries = []
    for name, want_k1, want_k2, want_k3 in MATRICES:
        report, rec, g = drive_matrix(dev, clock, name, want_k1, want_k2,
                                      want_k3)
        ents = kernel_entries(dev, clock, rec, report)
        report["kernels"] = ents
        report["profile"] = profile_path(dev, clock, g)
        entries += ents
        log(json.dumps({"matrix_report": report}))
        del rec, g
    names = {e["name"] for e in entries}
    assert names == {"segmented_accumulate", "dense_lu", "dense_lu_planar"}, \
        names
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
