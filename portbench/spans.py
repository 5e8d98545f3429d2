"""The port's own spans (``repro_torch.tracing``) in one cell: a stretch of
calls with the port's tracer on, and its reduction to per-call layer times
and set-up sums.

  python3 portbench/spans.py --workload grid128.sweep --seed 7 --seconds 20

runs the cell's set-up (planning, ``GLU.from_plan``, the warm call) with
the tracer on, its window with the tracer off (the timed path of
``run.py``), then at most ``STRETCH_CALLS`` calls or ``STRETCH_SECONDS``
with the tracer on and no profiler, judges every answer against the plain
reference as ``run.py`` does, and prints one JSON line.  The tracer stays
off in ``run.py``'s runs: inside a profiled call the port's
``record_function`` ranges would be device-side annotations, which
``tracing.reduce`` counts as work.

A call of the stretch is the host interval of one closed-loop call; its
spans are the port's spans inside it.  Per call (ms):

- ``prep_ms``: self time of ``glu.prepare`` and ``glu.finish``, the
  facade's numpy;
- ``launch_ms``: host time in ``exec.replay``, the graph launches;
- ``blocked_ms``: host time in ``glu.upload`` and ``glu.download``, the
  host held by copies and by the card's work queued before them;
- ``copy_ms``: device time of those spans' event pairs;
- ``replay_ms``: device time of ``exec.replay``'s event pairs;
- ``covered_pct``: the share of the call inside a root span;
- ``idle_ms``: the call's time with no event pair open on the card, split
  by the innermost span on the host at that moment.  Device times go onto
  the host clock through the call's first root span, whose first event is
  recorded while the closed loop leaves the card idle.

Set-up (s): ``plan_s``, every ``plan.*`` span (both MC64 runs:
planning's and ``from_plan``'s); ``build_s``, the outermost
``glu.setup``, ``exec.capture`` and ``kernels.*`` spans less the
``plan.*`` inside them.  The reduction takes the plain dicts of
``tracing.drain()``, so it runs on records made anywhere; without event
pairs (the CPU) the device figures are None.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parents[1]

STRETCH_CALLS = 16
STRETCH_SECONDS = 3.0
HOST = ("glu.prepare", "glu.finish")
TRANSFERS = ("glu.upload", "glu.download")
REPLAY = "exec.replay"
BUILD = ("glu.setup", "exec.capture", "kernels.load", "kernels.build")
OUTSIDE = "outside the program's spans"
PER_CALL = ("call_ms", "prep_ms", "launch_ms", "blocked_ms", "copy_ms", "replay_ms",
            "covered_pct")


def stretch(run_call: Callable[[int], None], calls: int = STRETCH_CALLS,
            seconds: float = STRETCH_SECONDS) -> tuple:
    """``run_call(i)`` for ``i = 0, 1, ...`` with the port's tracer on, at
    most ``calls`` calls and none begun after ``seconds``.  Returns the
    drained record and each call's host interval (ns)."""
    from repro_torch import tracing

    bounds = []
    tracing.drain()
    tracing.enable()
    try:
        t_end = time.perf_counter() + seconds
        for i in range(calls):
            t0 = time.perf_counter_ns()
            run_call(i)
            bounds.append((t0, time.perf_counter_ns()))
            if time.perf_counter() >= t_end:
                break
    finally:
        tracing.disable()
        record = tracing.drain()
    return record, bounds


def _dur(s) -> int:
    return s["end_ns"] - s["start_ns"]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _device_sum(spans: list) -> Optional[float]:
    if any("device_ms" not in s for s in spans):
        return None
    return sum(s["device_ms"] for s in spans)


def _innermost(spans: list, t: float) -> str:
    best = None
    for s in spans:
        if s["start_ns"] <= t <= s["end_ns"] and (best is None or _dur(s) < _dur(best)):
            best = s
    return OUTSIDE if best is None else best["name"]


def _idle(spans: list, t0: int, t1: int) -> Optional[dict]:
    """The call's time with no transfer or replay open on the card, by the
    innermost span on the host; None without event pairs."""
    roots = [s for s in spans if s["parent"] is None and "device_start_ms" in s]
    work = [s for s in spans if s["name"] in TRANSFERS + (REPLAY,)]
    if not roots or any("device_start_ms" not in s for s in work):
        return None
    anchor = roots[0]

    def host(ms):
        return anchor["start_ns"] + (ms - anchor["device_start_ms"]) * 1e6

    busy = _union([[max(host(s["device_start_ms"]), t0), min(host(s["device_end_ms"]), t1)]
                   for s in work])
    gaps, at = [], t0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    edges = sorted({e for s in spans for e in (s["start_ns"], s["end_ns"])})
    out: dict = {}
    for a, b in gaps:
        cuts = [a] + [e for e in edges if a < e < b] + [b]
        for x, y in zip(cuts, cuts[1:]):
            label = _innermost(spans, (x + y) / 2)
            out[label] = out.get(label, 0.0) + (y - x) / 1e6
    return out


def per_call(spans: list, bounds: list) -> list:
    """Each call's figures (see the module docstring) and counters."""
    out = []
    for t0, t1 in bounds:
        own = [s for s in spans if t0 <= s["start_ns"] and s["end_ns"] <= t1]
        kind = lambda *names: [s for s in own if s["name"] in names]  # noqa: E731
        roots = _union([[s["start_ns"], s["end_ns"]] for s in own if s["parent"] is None])
        counters: dict = {}
        for s in own:
            for k, v in s["counters"].items():
                counters[k] = counters.get(k, 0) + v
        replays = kind(REPLAY)
        out.append({
            "call_ms": (t1 - t0) / 1e6,
            "prep_ms": sum(s["self_ns"] for s in kind(*HOST)) / 1e6,
            "launch_ms": sum(_dur(s) for s in replays) / 1e6,
            "blocked_ms": sum(_dur(s) for s in kind(*TRANSFERS)) / 1e6,
            "copy_ms": _device_sum(kind(*TRANSFERS)),
            "replay_ms": _device_sum(replays) if replays else None,
            "covered_pct": 100.0 * sum(b - a for a, b in roots) / (t1 - t0),
            "idle_ms": _idle(own, t0, t1),
            "counters": counters})
    return out


def setup(spans: list) -> dict:
    """``plan_s`` and ``build_s`` of a set-up's spans (s)."""
    by_id = {s["id"]: s for s in spans}

    def under(s, names) -> bool:
        p = s["parent"]
        while p is not None:
            if by_id[p]["name"] in names:
                return True
            p = by_id[p]["parent"]
        return False

    plans = [s for s in spans if s["name"].startswith("plan.")]
    builds = [s for s in spans if s["name"] in BUILD and not under(s, BUILD)]
    inside = [s for s in plans if under(s, BUILD)]
    return {"plan_s": sum(_dur(s) for s in plans) / 1e9,
            "build_s": (sum(_dur(s) for s in builds) - sum(_dur(s) for s in inside)) / 1e9}


def _median(values: list):
    if not values or any(v is None for v in values):
        return None
    return statistics.median(values)


def summary(setup_record: dict, stretch_record: dict, bounds: list) -> dict:
    """The stretch's medians a call, the set-up sums, the idle split and
    the counters a call (the port's own counters over the stretch, a
    call)."""
    calls = per_call(stretch_record["spans"], bounds)
    out = {"calls": len(calls), **setup(setup_record["spans"])}
    out.update({k: _median([c[k] for c in calls]) for k in PER_CALL})
    idles = [c["idle_ms"] for c in calls]
    out["idle_ms"] = (None if not idles or None in idles else
                      {k: statistics.median([d.get(k, 0.0) for d in idles])
                       for k in sorted({k for d in idles for k in d})})
    keys = sorted({k for c in calls for k in c["counters"]})
    out["counters"] = {k: statistics.median([c["counters"].get(k, 0) for c in calls])
                       for k in keys}
    n = max(len(calls), 1)
    out["counters"].update({k: v / n for k, v in stretch_record["counters"].items()})
    return out


def measure(bench, cell: str, seed: int, seconds: float, device: str = "cuda",
            log=print) -> dict:
    """One run of ``cell``: set-up traced, the window untraced, the stretch
    traced, every answer judged.  Returns the summary, the window's and the
    stretch's median call (ms) and ``correct``."""
    import torch

    from portbench import workload
    from portbench.harness import REFERENCE_SAMPLE, _seed, judge
    from repro_torch import GLU, tracing
    from repro_torch.core import plan_factorization
    from repro_torch.sparse import CSC

    on_card = torch.device(device).type == "cuda"
    w = bench.cell(cell)
    cfg, mix = bench.config(w["config"]), bench.traffic(w["traffic"])
    traffic = workload.make(mix, cfg, bench.rule, _seed(seed))
    A = traffic.matrix
    A_port = CSC(A.n, A.indptr.copy(), A.indices.copy(), A.data.copy())
    opts = dict(cfg["glu"])
    opts["dtype"] = getattr(torch, cfg["dtypes"]["complex" if traffic.complex_values
                                                 else "real"])
    pool = len(traffic.values)
    answers = []

    def call(p):
        answers.append((p, workload.call(glu, traffic, p)))

    tracing.drain()
    tracing.enable()
    try:
        plan = plan_factorization(A_port, mc64=opts.get("mc64", "scale"), cache=None,
                                  **cfg.get("plan", {}))[0]
        glu = GLU.from_plan(plan, A_port, device=device, **opts)
        workload.call(glu, traffic, 0)
        if on_card:
            torch.cuda.synchronize()
    finally:
        tracing.disable()
        setup_record = tracing.drain()
    window = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        call((len(answers) + 1) % pool)
        window.append(time.perf_counter() - ts)
    base = len(answers)
    record, bounds = stretch(lambda i: call((base + i + 1) % pool))
    del glu, plan
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = judge(traffic, answers, bench.limits(cell), seed, REFERENCE_SAMPLE,
                           device, log)
    out = summary(setup_record, record, bounds)
    out.update(window_call_ms=statistics.median(window) * 1e3,
               window_calls=len(window),
               stretch_call_ms=out["call_ms"],
               correct=failed == 0 and all(c["value"] <= c["limit"] for c in checks.values()),
               checks=checks)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "torch_kernels")
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import Bench, card

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(Bench(ROOT), args.workload, args.seed, args.seconds)
    out["device"] = card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
