"""A traced run's records give each per-layer metric: records made by hand
on the CPU, with no timing, reduced as a card's would be."""
import pytest

from portbench import tracing
from portbench.counting import Work
from portbench.harness import Bench

BENCH = Bench()


def _records():
    """Two calls.  Call 1 (host 0-100 us): factor ops 10-20, 22-30, mark
    31-32, solve ops 40-50, 50-70 (touching), then a host memcpy wait.
    Call 2 (host 200-300 us): factor op 210-240, mark 241-242, solve ops
    250-260 and 255-265 (overlapping).  A user annotation on the device and
    the trailing spins are not work."""
    host = [(False, tracing.SPAN, 0.0, 100.0), (False, tracing.SPAN, 200.0, 300.0),
            (False, "cudaGraphLaunch", 5.0, 9.0), (False, "cudaMemcpyAsync", 70.0, 95.0),
            (False, "aten::copy_", 69.0, 96.0)]
    dev = [(True, "k1", 10.0, 20.0), (True, "k1", 22.0, 30.0),
           (True, "spin_kernel", 31.0, 32.0), (True, "tri", 40.0, 50.0),
           (True, "Memcpy DtoH", 50.0, 70.0), (True, "k1", 210.0, 240.0),
           (True, "spin_kernel", 241.0, 242.0), (True, "tri", 250.0, 260.0),
           (True, "tri", 255.0, 265.0), (True, tracing.SPAN, 0.0, 100.0)]
    dev += [(True, "spin_kernel", 310.0 + i, 310.5 + i) for i in range(tracing.TAIL_SPINS)]
    return host + dev


def test_reduce_splits_calls_by_the_mark():
    r = tracing.reduce(_records())
    assert [c["factor_ms"] for c in r["calls"]] == [pytest.approx(0.018), pytest.approx(0.030)]
    assert [c["solve_ms"] for c in r["calls"]] == [pytest.approx(0.030), pytest.approx(0.015)]
    assert [c["call_ms"] for c in r["calls"]] == [pytest.approx(0.1), pytest.approx(0.1)]
    # busy: 10-20, 22-30, 40-70, 210-240, 250-265 = 10+8+30+30+15 = 93 us of 300
    assert r["busy_s"] == pytest.approx(93e-6)
    assert r["window_s"] == pytest.approx(300e-6)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(48e-6) and ops["tri"] == pytest.approx(30e-6)
    assert "spin_kernel" not in ops and tracing.SPAN not in ops
    gaps = dict(r["breakdown"]["idle_gaps"])
    # 0-10 (cudaGraphLaunch covers 5), 20-22, 30-40, 70-210, 240-250, 265-300
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["host outside any recorded op"] == pytest.approx(140e-6)
    assert gaps[tracing.SPAN] == pytest.approx(57e-6)
    assert sum(gaps.values()) == pytest.approx(207e-6)


def test_reduce_leaves_out_a_call_whose_mark_was_dropped():
    recs = [r for r in _records() if not (r[1] == "spin_kernel" and r[2] == 31.0)]
    r = tracing.reduce(recs)
    assert len(r["calls"]) == 1 and r["calls"][0]["factor_ms"] == pytest.approx(0.030)
    assert tracing.reduce([r for r in recs if r[1] != "spin_kernel"]) is None


def test_per_layer_readers():
    traced = tracing.reduce(_records())
    rec = {"traced": traced, "call_s": [1e-3, 3e-3, 2e-3], "window_s": 0.0075, "calls": 3,
           "factor_work": Work(ops=67e12 * 1e-6, bytes=1.0),     # needs 1 us
           "solve_work": Work(ops=1.0, bytes=3.35e12 * 4.5e-6)}  # needs 4.5 us
    got = {m["name"]: BENCH.reader(m["name"]).read(rec) for m in BENCH.spec["per_layer"]}
    assert got["factor_ms"] == pytest.approx(0.024)
    assert got["solve_ms"] == pytest.approx(0.0225)
    # the untraced median call, 2 ms, less the traced busy time, 0.0465 ms a call
    assert got["host_ms"] == pytest.approx(2 - 0.0465)
    assert got["factor_roofline_pct"] == pytest.approx(100 * 1e-6 / 24e-6)
    assert got["solve_roofline_pct"] == pytest.approx(100 * 4.5e-6 / 22.5e-6)
    # busy 0.0465 ms of the untraced window's 2.5 ms a call
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - 0.0465 / 2.5))


def test_readers_return_nothing_without_a_trace():
    rec = {"call_s": [1e-3], "setup_s": 2.0, "window_s": 1.0, "systems": 10}
    for m in BENCH.spec["per_layer"]:
        assert BENCH.reader(m["name"]).read(rec) is None


def test_end_to_end_readers():
    rec = {"setup_s": 12.5, "window_s": 2.0, "systems": 640,
           "call_s": [0.01 * (i + 1) for i in range(100)]}
    got = {m["name"]: BENCH.reader(m["name"]).read(rec) for m in BENCH.spec["end_to_end"]}
    assert got["setup_s"] == 12.5
    assert got["systems_per_s"] == 320.0
    assert got["call_ms_p95"] == pytest.approx(950.5)
