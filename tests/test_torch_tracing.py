"""The port's tracer (``repro_torch.tracing``) on the CPU: nothing recorded
and no clock, event or synchronization while it is off; nesting, ids, self
time, byte counters, the planner's timers and the profiler's ranges while
it is on."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import GLU, tracing
from repro_torch.core import build_symbolic_plan, compute_scaling, plan_factorization
from repro_torch.sparse import grid_laplacian

BUILD_KEYS = {"ordering", "permute", "symbolic", "levelize", "plan", "total"}


@pytest.fixture(scope="module")
def problem():
    A = grid_laplacian(6, 5, seed=1)
    rng = np.random.default_rng(3)
    vals = np.asarray(A.data) * (1 + 0.1 * rng.random((3, A.nnz)))
    b = rng.standard_normal((3, A.n))
    return A, vals, b


@pytest.fixture
def glu(problem):
    return GLU(problem[0], device="cpu", plan_cache=None)


@pytest.fixture
def tracer():
    """The tracer on, and off and empty again after the test."""
    tracing.drain()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.drain()


def _raise(*a, **k):
    raise AssertionError("called while the tracer is off")


def test_off_records_nothing_and_reads_no_clock(glu, problem, monkeypatch):
    A, vals, b = problem
    tracing.drain()
    assert not tracing.enabled()
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(tracing, "time", type("NoClock", (), {"perf_counter_ns": _raise}))
    glu.factorize(np.asarray(A.data))
    x = glu.solve(b[0])
    xs = glu.refactorize_solve(vals, b, refine=1)
    assert glu.residual(b[0], x) < 1e-12 and np.isfinite(xs).all()
    monkeypatch.undo()
    assert tracing.drain()["spans"] == []


def test_spans_of_a_call(glu, problem, tracer):
    A, vals, b = problem
    glu.factorize(vals[0])
    glu.solve(b[0])
    glu.refactorize_solve(vals, b)
    spans = tracer.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["glu.factorize", "glu.solve",
                                         "glu.refactorize_solve"]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        top = s
        while top["parent"] is not None:
            parent = by_id[top["parent"]]
            assert parent["start_ns"] <= top["start_ns"] and top["end_ns"] <= parent["end_ns"]
            top = parent
        assert s["call"] == top["id"]
    names = lambda root: [s["name"] for s in spans if s["call"] == root["id"]]  # noqa: E731
    assert names(roots[0]) == ["glu.factorize", "glu.prepare", "glu.upload", "exec.eager"]
    assert names(roots[1]) == ["glu.solve", "glu.prepare", "glu.upload", "exec.eager",
                               "glu.download", "glu.finish"]
    assert names(roots[2])[:5] == ["glu.refactorize_solve", "glu.factorize_batched",
                                   "glu.prepare", "glu.upload", "exec.eager"]
    inner = [s for s in spans if s["name"] == "glu.solve_batched"]
    assert len(inner) == 1 and by_id[inner[0]["parent"]] is roots[2]
    assert roots[1]["counters"] == {"host_syncs": 0}
    for s in spans:
        kids = sum(k["end_ns"] - k["start_ns"] for k in spans if k["parent"] == s["id"])
        assert s["self_ns"] == s["end_ns"] - s["start_ns"] - kids >= 0


def test_nesting_and_self_time(tracer):
    with tracer.span("a"):
        time.sleep(0.002)
        with tracer.span("b"):
            with tracer.span("c", bytes_=torch.zeros(5, dtype=torch.float64)):
                time.sleep(0.001)
            tracer.count(n=2)
            tracer.count(n=3)
        with tracer.span("d"):
            pass
    with tracer.span("e"):
        pass
    spans = {s["name"]: s for s in tracer.drain()["spans"]}
    a, b, c, d, e = (spans[k] for k in "abcde")
    assert (a["parent"], b["parent"], c["parent"], d["parent"], e["parent"]) == \
        (None, a["id"], b["id"], a["id"], None)
    assert {s["call"] for s in (a, b, c, d)} == {a["id"]} and e["call"] == e["id"]
    dur = {k: s["end_ns"] - s["start_ns"] for k, s in spans.items()}
    assert a["self_ns"] == dur["a"] - dur["b"] - dur["d"] >= 2_000_000 * 0.9
    assert b["self_ns"] == dur["b"] - dur["c"] and c["self_ns"] == dur["c"]
    assert b["counters"] == {"n": 5} and c["counters"] == {"bytes_": 40}
    assert tracer.drain()["spans"] == []


def test_spans_nest_per_thread(tracer):
    """Threads open spans at once: each span's parent and call are its own
    thread's."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(50):
                with tracer.span(f"t{k}"):
                    with tracer.span(f"t{k}.child"):
                        pass
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = tracer.drain()["spans"]
    assert len(spans) == 16 * 50 * 2
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"].endswith(".child"):
            assert by_id[s["parent"]]["name"] + ".child" == s["name"]
            assert s["call"] == s["parent"]
        else:
            assert s["parent"] is None and s["call"] == s["id"]


@pytest.mark.parametrize("batch", [None, 3])
def test_transfer_bytes_a_call(glu, problem, tracer, batch):
    A, vals, b = problem
    if batch is None:
        glu.factorize(vals[0])
        glu.solve(b[0])
        rows = 1
    else:
        glu.refactorize_solve(vals[:batch], b[:batch])
        rows = batch
    spans = tracer.drain()["spans"]
    h2d = sum(s["counters"].get("h2d_bytes", 0) for s in spans)
    d2h = sum(s["counters"].get("d2h_bytes", 0) for s in spans)
    assert h2d == rows * (A.nnz + A.n) * 8
    assert d2h == rows * A.n * 8
    assert sum(s["counters"].get("eager_steps", 0) for s in spans) == \
        glu.solve_info["n_dispatches"] + glu.solve_info["solve_dispatches"]


def test_build_seconds_are_the_planner_spans(problem, tracer):
    A = problem[0]
    scaling = compute_scaling(A, "scale")
    plan = build_symbolic_plan(A.n, A.indptr, A.indices, scaling.row_perm,
                               ordering="mindeg")
    assert set(plan.build_seconds) == BUILD_KEYS
    spans = {s["name"]: s for s in tracer.drain()["spans"]}
    for key, name in [("ordering", "plan.ordering"), ("permute", "plan.permute"),
                      ("symbolic", "plan.symbolic"), ("levelize", "plan.levelize"),
                      ("plan", "plan.build")]:
        s = spans[name]
        assert plan.build_seconds[key] == (s["end_ns"] - s["start_ns"]) / 1e9
    assert "plan.mc64" in spans
    assert plan.build_seconds["total"] >= sum(
        v for k, v in plan.build_seconds.items() if k != "total")


def test_build_seconds_with_the_tracer_off(problem):
    tracing.drain()
    plan = plan_factorization(problem[0], cache=None)[0]
    assert set(plan.build_seconds) == BUILD_KEYS
    assert all(v >= 0 for v in plan.build_seconds.values())
    assert tracing.drain()["spans"] == []


def test_setup_spans_and_cache_counters(problem, tracer):
    g = GLU.from_plan(plan_factorization(problem[0], cache=None)[0], problem[0],
                      device="cpu", executable_cache=None)
    snap = tracer.drain()
    names = [s["name"] for s in snap["spans"]]
    assert names.count("plan.mc64") == 2            # planning's, and from_plan's
    setup = next(s for s in snap["spans"] if s["name"] == "glu.setup")
    kids = [s["name"] for s in snap["spans"] if s["parent"] == setup["id"]]
    assert kids == ["glu.setup.factorizer", "glu.setup.solver"]
    assert g.n == problem[0].n
    counters = snap["counters"]
    assert "launches.level_run" in counters and "plan_cache.builds" in counters
    # cache=None: the default plan cache did not move; from_plan's private
    # executable cache is not the default one either
    assert counters["plan_cache.builds"] == 0 and counters["executable_cache.builds"] == 0


def test_profiler_shows_the_spans(glu, problem, tracer):
    from torch.profiler import ProfilerActivity, profile

    A, vals, b = problem
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        glu.factorize(vals[0])
        glu.solve(b[0])
    seen = {e.name for e in prof.events()}
    assert {"glu.factorize", "glu.prepare", "glu.upload", "exec.eager", "glu.solve",
            "glu.download", "glu.finish"} <= seen
    assert len(tracer.drain()["spans"]) == 10


class _Clock:
    """A device clock for fake CUDA events: each record advances it."""
    ms = 0.0


class _Event:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream):
        _Clock.ms += 1.5
        self.t = _Clock.ms

    def query(self):
        return True

    def synchronize(self):
        raise AssertionError("a recorded event is complete here")

    def elapsed_time(self, other):
        return other.t - self.t


class _Stream:
    device = torch.device("cuda", 0)


def test_event_pairs_on_one_device_clock(tracer, monkeypatch):
    """With stand-ins for the card's events and stream: a span given a CUDA
    device records a pair, read on one clock from the first event."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    _Clock.ms = 100.0
    cuda = torch.device("cuda", 0)
    with tracer.span("root", cuda):             # events at 101.5 and 106.0
        with tracer.span("host"):
            pass
        with tracer.span("copy", cuda):         # 103.0, 104.5
            pass
    spans = {s["name"]: s for s in tracer.drain()["spans"]}
    assert "device_ms" not in spans["host"]
    assert spans["root"]["device_ms"] == pytest.approx(4.5)
    assert (spans["root"]["device_start_ms"], spans["root"]["device_end_ms"]) == (0.0, 4.5)
    assert spans["copy"]["device_ms"] == pytest.approx(1.5)
    assert spans["copy"]["device_start_ms"] == pytest.approx(1.5)
    assert spans["copy"]["device_end_ms"] == pytest.approx(3.0)


@pytest.fixture
def cuda():
    # decided here, never at import: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_event_pairs_on_the_card(problem, tracer, cuda):
    """On the card: the first calls capture, later ones replay; each
    transfer, replay and root span holds an event pair on one clock, read
    after the calls without a synchronization of theirs."""
    from torch.profiler import ProfilerActivity, profile

    A, vals, b = problem
    g = GLU(A, device=cuda, plan_cache=None)
    for _ in range(2):
        g.factorize(vals[0])
        g.solve(b[0])
    tracer.drain()
    syncs = []
    real_sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **k: syncs.append(1) or real_sync(*a, **k)
    try:
        g.factorize(np.asarray(A.data))
        x = g.solve(b[0])
    finally:
        torch.cuda.synchronize = real_sync
    assert not syncs
    spans = tracer.drain()["spans"]
    names = [s["name"] for s in spans]
    assert names == ["glu.factorize", "glu.prepare", "glu.upload", "exec.replay",
                     "glu.solve", "glu.prepare", "glu.upload", "exec.replay",
                     "glu.download", "glu.finish"]
    timed = [s for s in spans if "device_ms" in s]
    assert [s["name"] for s in timed] == ["glu.factorize", "glu.upload", "exec.replay",
                                          "glu.solve", "glu.upload", "exec.replay",
                                          "glu.download"]
    assert timed[0]["device_start_ms"] == 0.0
    for s in timed:
        assert 0 <= s["device_start_ms"] <= s["device_end_ms"]
        assert s["device_ms"] == pytest.approx(s["device_end_ms"] - s["device_start_ms"],
                                               abs=1e-3)
    assert sum(s["counters"].get("h2d_bytes", 0) for s in spans) == (A.nnz + A.n) * 8
    assert sum(s["counters"].get("d2h_bytes", 0) for s in spans) == A.n * 8
    assert sum(s["counters"].get("replays", 0) for s in spans) == 2
    assert g.residual(b[0], x) < 1e-9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.factorize(vals[0])
        g.solve(b[0])
    assert {"glu.factorize", "exec.replay", "glu.download"} <= {e.name for e in prof.events()}
    tracer.drain()
