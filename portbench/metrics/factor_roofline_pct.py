"""The least time the factorization's work needs (``counting.factor_work``,
counted from the filled pattern) over its mean device time
(``factor_ms``) in the traced calls, in %."""


def read(rec):
    calls = rec.get("traced", {}).get("calls")
    if not calls or "factor_work" not in rec:
        return None
    ms = sum(c["factor_ms"] for c in calls) / len(calls)
    return 100.0 * rec["factor_work"].least_s() / (ms / 1e3) if ms > 0 else None
