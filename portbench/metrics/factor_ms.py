"""The factorization's device time in a traced call, in ms: the busy time
(union of intervals) of the card's ops between the call's start and the
mark set when ``factorize``/``factorize_batched`` returns (the values'
upload, entry scatter, levels, dense tail), mean over the traced calls."""


def read(rec):
    calls = rec.get("traced", {}).get("calls")
    return sum(c["factor_ms"] for c in calls) / len(calls) if calls else None
