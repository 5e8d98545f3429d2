"""The traced stretch of a ``--trace 1`` run and its reduction to per-call
layer times, the device's busy time and the breakdown.

The profiler (``torch.profiler``, CUPTI) records a few calls of the timed
path, each call a ``portbench.call`` span on the host.  When the
factorization's public call returns, a spin kernel marks the card's stream,
so the device's records of a call split by stream order, whatever kernels
or graphs the port launches: the factorization's ops run between the call's
start and the mark, the solve's between the mark and the call's end (the
solve hands solutions to the host, so its ops end inside the call).

Trailing spin kernels follow the last call: late in a run the profiler has
been seen to drop device records (frozen from ``chip_smoke._profile``).  A
call whose mark was dropped is left out.  Spins are never counted as work.

CUPTI's tracing of graph kernels widens the gaps between them, not the
kernels themselves (on an H100, a traced Newton call of 8,918 small
kernels took 30-48 ms, an untraced one 20-23 ms, 19.3 ms of kernels either
way).  So a layer's time is its ops' busy time (the union of their
intervals), and what the host adds to a call is read against the untraced
window (``metrics/host_ms.py``, ``metrics/device_idle_pct.py``), never
against the traced call.  The stretch's own ``busy_s`` and ``window_s``
keep the widened gaps.

The reduction takes plain tuples ``(on_device, name, start_us, end_us)``,
so it runs on records made anywhere.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

SPAN = "portbench.call"
SPIN = "spin_kernel"
TAIL_SPINS = 16
MARK_CYCLES = 1000
NAME_CHARS = 160


def record(n_calls: int, run_call: Callable[[int, Callable[[], None]], None]):
    """Profile ``n_calls`` calls of ``run_call(i, mark)`` on the card;
    ``run_call`` calls ``mark()`` when the factorization returns.  Returns
    the normalized records."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def mark():
        torch.cuda._sleep(MARK_CYCLES)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n_calls):
                with record_function(SPAN):
                    run_call(i, mark)
            for _ in range(TAIL_SPINS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
    return normalize(prof)


def normalize(prof) -> list:
    """The profiler's raw events as ``(on_device, name, start_us,
    end_us)``."""
    import torch

    out = []
    for ev in prof.profiler.kineto_results.events():
        try:
            start, dur = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
        except AttributeError:
            start, dur = float(ev.start_us()), float(ev.duration_us())
        on_dev = ev.device_type() == torch.autograd.DeviceType.CUDA
        out.append((on_dev, ev.name(), start, start + dur))
    return out


def _merge(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """(k, 2) union of the intervals, in order."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(s) - 1)
    return np.stack([s[idx], e[last]], axis=1)


def _busy_ms(s: np.ndarray, e: np.ndarray, keep: np.ndarray) -> float:
    if not keep.any():
        return 0.0
    m = _merge(s[keep], e[keep])
    return float((m[:, 1] - m[:, 0]).sum()) / 1e3


def _top(d: dict) -> list:
    return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _labels(mids: np.ndarray, host: list, chunk: int = 2048) -> list:
    """The innermost host event running at each time in ``mids``."""
    if not host:
        return ["host outside any recorded op"] * len(mids)
    hs = np.array([h[0] for h in host])
    he = np.array([h[1] for h in host])
    dur = he - hs
    out = []
    for c in range(0, len(mids), chunk):
        m = mids[c:c + chunk, None]
        d = np.where((hs[None, :] <= m) & (he[None, :] >= m), dur[None, :], np.inf)
        pick = d.argmin(axis=1)
        out += [host[j][2] if np.isfinite(d[i, j]) else "host outside any recorded op"
                for i, j in enumerate(pick)]
    return out


def reduce(events: list) -> Optional[dict]:
    """Per-call layer times (ms), busy and window seconds, and the
    breakdown of the traced stretch; None when no call kept its mark."""
    calls = sorted((s, e) for dev, name, s, e in events if not dev and name == SPAN)
    spins = np.array(sorted(s for dev, name, s, e in events if dev and SPIN in name))
    spin_end = {s: e for dev, name, s, e in events if dev and SPIN in name}
    ops = [(s, e, name) for dev, name, s, e in events
           if dev and SPIN not in name and not name.startswith("portbench.")]
    if not calls or not ops:
        return None
    os_ = np.array([o[0] for o in ops])
    oe = np.array([o[1] for o in ops])
    per_call = []
    for cs, ce in calls:
        mid = spins[(spins > cs) & (spins < ce)]
        if len(mid) != 1:
            continue
        m0 = mid[0]
        fk = (os_ >= cs) & (oe <= m0)
        sk = (os_ >= spin_end[m0]) & (oe <= ce)
        per_call.append({"call_ms": (ce - cs) / 1e3,
                         "factor_ms": _busy_ms(os_, oe, fk),
                         "solve_ms": _busy_ms(os_, oe, sk)})
    if not per_call:
        return None
    w0, w1 = calls[0][0], calls[-1][1]
    inside = (oe > w0) & (os_ < w1)
    if not inside.any():
        return None
    cs_, ce_ = np.maximum(os_[inside], w0), np.minimum(oe[inside], w1)
    busy = _merge(cs_, ce_)
    by_name: dict = {}
    for n, d in zip((o[2] for o, k in zip(ops, inside) if k), ce_ - cs_):
        by_name[n] = by_name.get(n, 0.0) + float(d) / 1e6
    g0 = np.concatenate([[w0], busy[:, 1]])
    g1 = np.concatenate([busy[:, 0], [w1]])
    real = g1 > g0
    g0, g1 = g0[real], g1[real]
    host = [(s, e, name) for dev, name, s, e in events if not dev]
    gaps: dict = {}
    for label, d in zip(_labels((g0 + g1) / 2, host), g1 - g0):
        gaps[label] = gaps.get(label, 0.0) + float(d) / 1e6
    return {"calls": per_call,
            "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "breakdown": {"device_ops": _top(by_name), "idle_gaps": _top(gaps)}}
