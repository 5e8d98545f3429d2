"""The share of a call in which no operation runs on the card, in %:
1 - (the factorization's and the solve's busy time, mean over the traced
calls) / (the untraced window's time a call).  The traced stretch's own
idle share (``device.busy_s`` over ``device.window_s``) keeps the gaps the
profiler widens, and is not this."""


def read(rec):
    calls = rec.get("traced", {}).get("calls")
    if not calls or not rec.get("calls"):
        return None
    busy = sum(c["factor_ms"] + c["solve_ms"] for c in calls) / len(calls)
    return 100.0 * (1.0 - busy / (1e3 * rec["window_s"] / rec["calls"]))
