"""Time the default path's factorization replay of two source trees on one
NVIDIA GPU, in turns: a change that adds options to the factorizer must
leave the default path's schedule, bits and time as they were.

    python3 tools/ab_factorize_replay.py PARENT_TREE CHANGE_TREE

As ``tools/ab_single_kernels.py`` (parent, change, change, parent, each in
a fresh process that builds its own kernels): for grid64 and rajat12_like
at scale 1.0, ``GLU(A)`` as a user builds it, one factorization (the
eager warm-up and the capture), then the replay timed with CUDA events
over 50 calls after a warm-up; the steps a factorization issues one by
one and a digest of the factored values' bytes are printed beside it.
"""
from __future__ import annotations

import sys

from ab_single_kernels import main

CHILD = r'''
import hashlib, json
import torch
from repro_torch import GLU
from repro_torch.sparse import make_suite_matrix

def ms(fn, reps=50):
    fn(); torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

out = {}
for name in ("grid64", "rajat12_like"):
    g = GLU(make_suite_matrix(name, 1.0))
    g.factorize()
    out[f"{name}_replay_ms"] = ms(g._factorizer.run)
    out[f"{name}_eager_steps"] = 1 + g._factorizer.n_groups
    v = g.factorize().factorized_values().cpu().numpy()
    out[f"{name}_bits"] = int(hashlib.sha256(v.tobytes()).hexdigest()[:12], 16)
print(json.dumps(out))
'''

if __name__ == "__main__":
    sys.exit(main(CHILD, __doc__))
