"""What a call holds on the host beyond the card's work, in ms: the
median untraced call of the window (host clock) less the mean busy time of
the factorization and the solve in the traced calls.  The facade's numpy
(``core/api.py``), launches, transfer set-up and the waits between the two
public calls.  The traced calls' own length is not used: the profiler
widens the gaps between kernels."""
import statistics


def read(rec):
    calls = rec.get("traced", {}).get("calls")
    if not calls or not rec.get("call_s"):
        return None
    busy = sum(c["factor_ms"] + c["solve_ms"] for c in calls) / len(calls)
    return statistics.median(rec["call_s"]) * 1e3 - busy
