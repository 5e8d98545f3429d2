"""The solve's device time in a traced call, in ms: the busy time (union of
intervals) of the card's ops after the mark (the right-hand sides'
upload, the triangular sweeps, refinement where the cell refines, the
solutions' download), mean over the traced calls."""


def read(rec):
    calls = rec.get("traced", {}).get("calls")
    return sum(c["solve_ms"] for c in calls) / len(calls) if calls else None
