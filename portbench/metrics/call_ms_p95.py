"""95th percentile of every call of the window, host values in to host
solutions out (host clock), in ms."""
import statistics


def read(rec):
    if len(rec["call_s"]) < 2:
        return None
    return statistics.quantiles(rec["call_s"], n=100, method="inclusive")[94] * 1e3
