"""One run of one cell: set-up, the measured window, the traced stretch,
the judgement of every answer against the plain reference, and the result
line.

Everything particular to a cell is data, found by the names in
``BENCHMARK.json``: the configuration's file (its ``file`` entry), the mix
``traffic/<traffic>.json``, the cell's limits ``limits/<cell>.json``, the
rules ``rules/<rule>.py`` those name, and one reader
``metrics/<metric>.py`` for each metric the cell reports.  Adding a cell,
configuration, mix or metric adds files and entries; no file here changes.

The port is driven only through its public entry points:
``repro_torch.core.plan_factorization``, ``repro_torch.GLU`` (``from_plan``,
``factorize``, ``solve``, ``factorize_batched``, ``solve_batched``,
``refactorize_solve``) and the ``repro_torch.sparse.CSC`` it takes.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import resource
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from portbench import counting, reference, tracing, workload

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level names, whole
TRACE_TRIES = 3
TRACE_CALLS = 4          # calls the profiler records in a --trace 1 run
REFERENCE_SAMPLE = 16    # answers the dense reference solves a run


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro_torch`` is the port, and is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files its names lead to, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._rules: dict = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def rule(self, name: str):
        if name not in self._rules:
            self._rules[name] = _module(self.dir / "rules" / f"{name}.py",
                                        f"portbench_rule_{name}")
        return self._rules[name]

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metric entries: end-to-end ones untraced, per-layer
        ones traced."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        return _module(self.dir / "metrics" / f"{name}.py",
                       f"portbench_metric_{name.replace('.', '_')}")


def card() -> dict:
    """The card's name, count and power limit."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        out["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    return out


def _seed(seed: int) -> int:
    return int(seed) & ((1 << 64) - 1)


def judge(t: workload.Traffic, answers: list, limits: dict, seed: int,
          sample: int, device, log=print) -> tuple:
    """Every answer's backward error, and the forward error of a seeded
    sample against the dense reference.  Returns (checks, failed)."""
    A = t.matrix
    t0 = time.perf_counter()
    berr = np.concatenate([
        reference.backward_errors(A.n, A.indptr, A.indices, t.values[p],
                                  t.rhs[p], x, device) for p, x in answers])
    lim_b = float(limits["berr_max"])
    failed = int((~(berr <= lim_b)).sum())
    B = t.batch
    pick = np.random.default_rng([_seed(seed), 1]).choice(
        len(answers) * B, size=min(sample, len(answers) * B), replace=False)
    vals = np.stack([t.values[answers[k // B][0]][k % B] for k in pick])
    rhs = np.stack([t.rhs[answers[k // B][0]][k % B] for k in pick])
    x = np.stack([answers[k // B][1][k % B] for k in pick])
    t1 = time.perf_counter()
    x_ref = reference.dense_solve(A.n, A.indptr, A.indices, vals, rhs, device)
    log(f"reference: backward errors {t1 - t0:.3f} s, dense solves "
        f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    ferr = reference.forward_errors(x, x_ref)
    checks = {"berr_max": {"value": float(berr.max()), "limit": lim_b},
              "ferr_max": {"value": float(ferr.max()),
                           "limit": float(limits["ferr_max"])}}
    return checks, failed


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None, plans: Optional[dict] = None,
             log=print) -> dict:
    """One run of ``cell``; returns the result line's object.  ``t_start``:
    the process's start on ``time.perf_counter``'s clock.  ``overrides``
    replace GLU options (the control's lower precision).  ``plans``, a
    dict kept across calls, lends one process's runs of a cell one plan
    (``calibrate.py``); a benchmark run plans in its set-up."""
    import torch

    from repro_torch import GLU
    from repro_torch.core import plan_factorization
    from repro_torch.sparse import CSC

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    w = bench.cell(cell)
    cfg, mix, limits = bench.config(w["config"]), bench.traffic(w["traffic"]), bench.limits(cell)
    parts = {"import_s": time.perf_counter() - t_start}

    t = time.perf_counter()
    traffic = workload.make(mix, cfg, bench.rule, _seed(seed))
    A = traffic.matrix
    A_port = CSC(A.n, A.indptr.copy(), A.indices.copy(), A.data.copy())
    parts["inputs_s"] = time.perf_counter() - t

    opts = dict(cfg["glu"])
    opts["dtype"] = cfg["dtypes"]["complex" if traffic.complex_values else "real"]
    opts.update(overrides or {})
    opts["dtype"] = getattr(torch, opts["dtype"])
    t = time.perf_counter()
    plans = {} if plans is None else plans
    if cell not in plans:
        plans[cell] = plan_factorization(A_port, mc64=opts.get("mc64", "scale"),
                                         cache=None, **cfg.get("plan", {}))[0]
    plan = plans[cell]
    parts["plan_s"] = time.perf_counter() - t
    t = time.perf_counter()
    glu = GLU.from_plan(plan, A_port, device=device, **opts)
    parts["glu_s"] = time.perf_counter() - t

    t = time.perf_counter()
    split = (lambda p, between: workload.call_split(glu, traffic, p, between)) if trace \
        else (lambda p, between: workload.call(glu, traffic, p))
    split(0, lambda: None)                  # builds, warms and captures
    if on_card:
        torch.cuda.synchronize()
    parts["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    parts["host_peak_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log("setup " + json.dumps({k: round(v, 3) for k, v in parts.items()}),
        file=sys.stderr)

    pool = len(traffic.values)
    answers, call_s = [], []
    t0 = te = time.perf_counter()
    while te - t0 < seconds:
        p = (len(answers) + 1) % pool
        ts = time.perf_counter()
        answers.append((p, split(p, lambda: None)))
        te = time.perf_counter()
        call_s.append(te - ts)
    window_s = te - t0
    n_window = len(answers)
    q = np.percentile(call_s, [5, 50, 95, 100]) * 1e3
    log(f"calls {n_window} in {window_s:.3f} s; ms p5 {q[0]:.3f} p50 {q[1]:.3f} "
        f"p95 {q[2]:.3f} max {q[3]:.3f}", file=sys.stderr)

    traced = None
    if trace and on_card:
        k = TRACE_CALLS
        for _ in range(TRACE_TRIES):
            base = len(answers)

            def run_call(i, mark):
                p = (base + i + 1) % pool
                answers.append((p, split(p, mark)))

            traced = tracing.reduce(tracing.record(k, run_call))
            if traced is not None and len(traced["calls"]) == k:
                break
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    rec = {"setup_s": setup_s, "window_s": window_s, "calls": n_window,
           "systems": n_window * traffic.batch, "call_s": call_s}
    if traced is not None:
        P = plan.pattern
        support = None if traffic.rhs_pattern is None else plan.row_map[traffic.rhs_pattern]
        rec.update(traced=traced,
                   factor_work=counting.factor_work(P.n, P.indptr, P.indices, A.nnz,
                                                    traffic.complex_values, traffic.batch),
                   solve_work=counting.solve_work(P.n, P.indptr, P.indices,
                                                  traffic.complex_values, traffic.batch,
                                                  support))
    del glu, plan
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks, failed = judge(traffic, answers, limits, seed, REFERENCE_SAMPLE, device, log)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in bench.metrics(cell, trace):
        value = bench.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = card() if on_card else {"platform": "cpu", "kind": "cpu", "count": 0}
    dev["memory_peak_bytes"] = int(peak)
    out = {"correct": bool(correct), "attempted": len(answers) * traffic.batch,
           "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        out["breakdown"] = traced["breakdown"]
    out["checks"] = checks
    return out
