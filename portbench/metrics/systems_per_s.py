"""Linear systems factored and solved per second: every system the window
completed over the window's whole time (host clock)."""


def read(rec):
    return rec["systems"] / rec["window_s"]
