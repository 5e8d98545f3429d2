"""The least time one solve's work needs (``counting.solve_work``, counted
from the filled pattern and, for a pruned solve, the right-hand sides'
reach) over the solve's mean device time (``solve_ms``) in the traced
calls, in %.
Refinement's further sweeps are not counted as needed work."""


def read(rec):
    calls = rec.get("traced", {}).get("calls")
    if not calls or "solve_work" not in rec:
        return None
    ms = sum(c["solve_ms"] for c in calls) / len(calls)
    return 100.0 * rec["solve_work"].least_s() / (ms / 1e3) if ms > 0 else None
