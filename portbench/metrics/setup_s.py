"""Process start to the first timed call: planning, the GLU's build, the
kernels' load (their build in a checkout's first run) and the warm call
that captures the cell's CUDA graphs (host clock)."""


def read(rec):
    return rec["setup_s"]
