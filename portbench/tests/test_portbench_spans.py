"""The port's spans in a cell (``portbench/spans.py``): the reduction on
span records made by hand, the stretch on the CPU's small cells, and the
tracer left off by ``run.py``'s runs."""
import pytest

from portbench import spans
from portbench.harness import run_cell

MS = 1_000_000


def _records(rows):
    """``(id, name, parent, start_ms, end_ms, device_start_ms or None,
    device_end_ms, counters)`` as ``tracing.drain()`` gives them."""
    out = []
    by_id = {r[0]: r for r in rows}
    for i, name, parent, s, e, ds, de, counters in rows:
        kids = sum(r[4] - r[3] for r in rows if r[2] == i)
        top = i
        while by_id[top][2] is not None:
            top = by_id[top][2]
        rec = {"name": name, "id": i, "parent": parent, "call": top,
               "start_ns": round(s * MS), "end_ns": round(e * MS),
               "self_ns": round((e - s - kids) * MS), "counters": counters or {}}
        if ds is not None:
            rec.update(device_start_ms=ds, device_end_ms=de, device_ms=de - ds)
        out.append(rec)
    return out


# one call, 0-100 ms: a factorization whose replay runs on past its return,
# then a solve whose upload waits for it (device ms on the anchor's clock,
# the factorization's first event at host 1 ms)
CALL = [
    (1, "glu.factorize", None, 1, 30, 0.0, 40.0, None),
    (2, "glu.prepare", 1, 2, 10, None, None, None),
    (3, "glu.upload", 1, 10, 14, 9.5, 12.5, {"h2d_bytes": 800}),
    (4, "exec.replay", 1, 14, 15, 14.2, 40.0, {"replays": 1}),
    (5, "glu.solve", None, 31, 95, 29.0, 94.0, {"host_syncs": 0}),
    (6, "glu.prepare", 5, 32, 35, None, None, None),
    (7, "glu.upload", 5, 35, 42, 40.0, 41.0, {"h2d_bytes": 80}),
    (8, "exec.replay", 5, 42, 42.5, 41.2, 60.0, {"replays": 1}),
    (9, "glu.download", 5, 42.5, 62, 60.0, 60.5, {"d2h_bytes": 80}),
    (10, "glu.finish", 5, 62, 90, None, None, None),
]


def test_per_call_figures():
    [c] = spans.per_call(_records(CALL), [(0, 100 * MS)])
    assert c["call_ms"] == 100.0
    assert c["prep_ms"] == pytest.approx(8 + 3 + 28)
    assert c["launch_ms"] == pytest.approx(1 + 0.5)
    assert c["blocked_ms"] == pytest.approx(4 + 7 + 19.5)
    assert c["copy_ms"] == pytest.approx(3 + 1 + 0.5)
    assert c["replay_ms"] == pytest.approx(25.8 + 18.8)
    assert c["covered_pct"] == pytest.approx(29 + 64)
    assert c["counters"] == {"h2d_bytes": 880, "d2h_bytes": 80, "replays": 2,
                             "host_syncs": 0}
    # busy on the host clock: 10.5-13.5, 15.2-42, 42.2-61.5
    want = {spans.OUTSIDE: 1 + 5, "glu.factorize": 1 + 0.2, "glu.prepare": 8,
            "glu.upload": 0.5 + 0.5, "exec.replay": 1 + 0.2, "glu.download": 0.5,
            "glu.finish": 28, "glu.solve": 5}
    assert c["idle_ms"] == pytest.approx(want)
    assert sum(c["idle_ms"].values()) == pytest.approx(100 - 3 - 26.8 - 19.3)


def test_without_event_pairs_the_device_figures_are_none():
    host_only = [r[:5] + (None, None) + r[7:] for r in CALL]
    [c] = spans.per_call(_records(host_only), [(0, 100 * MS)])
    assert c["copy_ms"] is None and c["replay_ms"] is None and c["idle_ms"] is None
    assert c["blocked_ms"] == pytest.approx(30.5) and c["prep_ms"] == pytest.approx(39)


SETUP = [
    (1, "plan.mc64", None, 0, 1000, None, None, None),
    (2, "plan.ordering", None, 1000, 3000, None, None, None),
    (3, "plan.build", None, 3000, 3500, None, None, None),
    (4, "plan.mc64", None, 3600, 4600, None, None, None),        # from_plan's
    (5, "glu.setup", None, 4600, 9600, None, None, None),
    (6, "glu.setup.factorizer", 5, 4700, 8000, None, None, None),
    (7, "plan.symbolic", 5, 8000, 8100, None, None, None),       # inside a build
    (8, "glu.factorize", None, 9700, 12000, None, None, None),   # the warm call
    (9, "exec.capture", 8, 9800, 11900, None, None, None),
    (10, "kernels.load", 9, 9900, 10900, None, None, None),
    (11, "kernels.build", 10, 9950, 10850, None, None, None),
]


def test_setup_sums():
    got = spans.setup(_records(SETUP))
    assert got["plan_s"] == pytest.approx(1 + 2 + 0.5 + 1 + 0.1)
    assert got["build_s"] == pytest.approx(5 + 2.1 - 0.1)


def test_summary_takes_medians_a_call():
    calls = []
    for k in range(3):
        shift = 1000 * k
        calls += [(i + 100 * k, n, None if p is None else p + 100 * k, s + shift, e + shift,
                   ds, de, c) for i, n, p, s, e, ds, de, c in CALL]
    record = {"spans": _records(calls), "counters": {"launches.level_run": 6}}
    bounds = [(1000 * k * MS, (1000 * k + 100) * MS) for k in range(3)]
    out = spans.summary({"spans": _records(SETUP), "counters": {}}, record, bounds)
    assert out["calls"] == 3 and out["prep_ms"] == pytest.approx(39)
    assert out["replay_ms"] == pytest.approx(44.6)
    assert out["counters"]["replays"] == 2 and out["counters"]["launches.level_run"] == 2
    assert out["idle_ms"]["glu.finish"] == pytest.approx(28)
    assert out["plan_s"] == pytest.approx(4.6)


@pytest.mark.parametrize("cell", ["tinyh.newton", "tinyg.sweep"])
def test_measure_on_the_cpu(tiny_bench, cell):
    from repro_torch import tracing

    out = spans.measure(tiny_bench, cell, 2**31 + 5, 0.3, device="cpu",
                        log=lambda *a, **k: None)
    assert out["correct"] and out["calls"] >= 1 and out["window_calls"] >= 1
    for key in ("prep_ms", "launch_ms", "blocked_ms", "plan_s", "build_s"):
        assert out[key] is not None and out[key] >= 0
    assert out["prep_ms"] > 0 and out["blocked_ms"] > 0 and out["plan_s"] > 0
    assert out["launch_ms"] == 0                     # no graph on the CPU
    assert out["copy_ms"] is None and out["replay_ms"] is None and out["idle_ms"] is None
    assert out["covered_pct"] > 50
    w = tiny_bench.cell(cell)
    t = tiny_bench.traffic(w["traffic"])
    B = 1 if t["call"] == "factorize_solve" else t["batch"]
    cfg = tiny_bench.config(w["config"])["matrix"]["args"]
    n = cfg["nx"] * cfg["ny"]
    assert out["counters"]["d2h_bytes"] == B * n * 8
    assert out["counters"]["h2d_bytes"] > B * n * 8
    assert out["counters"]["eager_steps"] > 0 and "replays" not in out["counters"]
    assert not tracing.enabled() and tracing.drain()["spans"] == []


def test_run_cell_leaves_the_tracer_off(tiny_bench):
    """The window and the profiled stretch run with the port's tracer off:
    nothing is recorded."""
    from repro_torch import tracing

    tracing.drain()
    out = run_cell(tiny_bench, "tinyh.newton", 9, 0.2, True, device="cpu",
                   log=lambda *a, **k: None)
    assert out["correct"]
    assert not tracing.enabled() and tracing.drain()["spans"] == []


def test_run_cell_leaves_the_tracer_off_on_the_card(tiny_bench, card):
    from repro_torch import tracing

    tracing.drain()
    out = run_cell(tiny_bench, "tinyh.newton", 9, 0.3, True, device="cuda",
                   log=lambda *a, **k: None)
    assert out["correct"] and "breakdown" in out
    assert not tracing.enabled() and tracing.drain()["spans"] == []
