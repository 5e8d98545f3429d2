#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

 1. the card's name and power limit (``nvidia-smi``);
 2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
 3. each kernel against its plain PyTorch version at the main path's
    shapes: K1 ``level_run`` on synthetic runs in float64, float32,
    complex128 and complex64, bit for bit and repeated bit for bit (runs of
    grid64's widest levels, rajat12_like's maxima D 801, R 2,355, C 794, a
    row of more than 1,024 slots, all-duplicate positions, one level); K1's
    robust (static-pivot) instantiation in the four dtypes on the same
    runs with diagonals crushed below tau in every level (complex ones by
    magnitude, phase kept, some exact zeros; complex ones at B = 4 with
    per-matrix tau too), bit for bit and bump for bump; K2 and K3 in
    float64 and float32 (complex128 and
    complex64 planes for K3) with the stated tolerances and against their
    componentwise backward error, from a single block (N = 32) to more
    blocks than the card keeps CTAs resident (K2 at N = 2048), with ``a``
    left unchanged and a second call bit-identical;
 4. for each matrix (grid64 and rajat12_like, real, at scale 1.0; then
    rajat12_ac, the complex AC matrix ``G + jwC`` on rajat12_like's
    pattern): plan on the host, build ``GLU(A)`` on the card (each
    factorization and each solve one CUDA-graph replay; the first call of
    each runs the steps eagerly while it warms up the graph) and drive the
    path (factorize + solve) with every launch counter set to 0 just before
    and read just after: one K1 launch per run of K1 levels (one run on
    each matrix), and the K2 and K3 counts equal to the dense groups;
 5. refactorizations with fresh values (real matrices: a Newton-like
    perturbation from a numpy seed; rajat12_ac: other frequencies in a
    decade around 1e3 rad/s), each one replay (``n_dispatches == 1``, one
    K1 launch per run counted from the replay) solved by one replay with
    ``residual < 1e-9``; the same values through ``GLU(A,
    jit_schedule=False)`` (the steps one by one) give the same factors and
    solutions bit for bit, refined solves too; two factorizations and
    solves of the same values are bit-identical;
 6. timings with CUDA events after warm-up, values already on the card:
    factorization (one replay, and the steps one by one) and solve (the
    same two), and each kernel, its plain version and a library yardstick
    replayed on the exact inputs the main path gave the kernel (K1: the
    value array just before the run, which must come out of the kernel bit
    for bit as out of its plain version; its yardstick is the library
    route, the per-level eager steps with one ``scatter_add_`` a level);
    bounds from the bytes and operations of those inputs; peak device
    memory; device kernels and device-busy share per factorization and per
    solve for both (torch.profiler), beside this host's cost of one small
    op; the eager factorization must show exactly one run-kernel device
    kernel per run and one dense-LU device kernel per dense group (K1, K2
    and K3 are one device kernel a call); each kernel prints its time over
    the yardstick's;
 7. static pivot: ``GLU(grid64, static_pivot=1e-10)`` driven with the
    counters at 0 (K1's robust instantiation inside the graph), replays
    against the steps one by one bit for bit over refactorizations (with
    ``static_pivot=0.6`` too, where bumps fire: equal bump counts), and the
    robust K1 timed on the path's recorded run against its plain version
    and the library route;
 8. transient: ``transient(rc_grid_circuit(64, 64, with_diodes=True,
    seed=0), t_end=0.1, dt=5e-3, refine=1)`` (n = 4,096, 20 time steps)
    with the counters at 0: ``max_residual < 1e-8``, finite voltages,
    ``n_factorizations == newton_iters.sum()``, one K1 and one K2 launch
    per factorization, refactorize-only ladder counts, voltages bit for
    bit those of the same run with ``jit_schedule=False``; then a
    per-Newton-iterate breakdown: assembly, host preparation, host-to-device
    copies, factorization replay, solve replays, device-to-host copy;
 9. the batched engine on grid64 and rajat12_like at B = 1 and 16 (each
    entry times 1 + 0.1 U(-1, 1) from the seed), with the counters at 0:
    one batched K1 launch per run and one batched K2 launch per batched
    factorization, each matrix's refined residual < 1e-9; a refactorization
    with fresh values is one replay for ``factorize_batched`` and one for
    ``solve_batched``, bit for bit the batched steps one by one and one
    ``GLU`` a matrix (factors, solutions, refined solutions); timings of
    the batched replays against B single replays, device kernels and busy
    share; at B = 16 the batched K1 and K2 on the recorded inputs against
    their plain versions and the library yardsticks (the per-level eager
    route on (B, n) values, ``lu_factor(pivot=False)`` on the (B, N, N)
    batch);
10. the same for rajat12_ac at B = 8 frequencies over 10^2.5-10^3.5 rad/s
    (batched K1 on complex values, batched K3);
11. static pivoting on a batch: ``GLU(grid64, static_pivot=...)`` at
    B = 4, eps 1e-10 and 0.6, per-matrix bump counts equal between the
    replays, the steps one by one and one ``GLU`` a matrix, and the batched
    robust K1 against its plain version bump for bump;
12. ``transient_sweep`` of 8 copies of the 64 × 64 grid (scales
    0.8-1.2, t_end 0.05, dt 5e-3, refine=1) with the counters at 0:
    ``max_residual < 1e-8``, one K1 and one K2 launch per batched
    factorization, every copy within 1e-9 of ``transient`` on its own
    circuit, and a per-iterate breakdown of the batch;
13. pruned and many-RHS solves on grid64, rajat12_like and rajat12_ac
    (counters at 0 for their factorizations): ``rhs_pattern`` of one node,
    three nodes and every node, each pruned replay bit for bit the full
    replay (exact zeros off the reach), its warm-up and the pruned steps
    one by one; reach sizes, levels kept, device kernels a solve and the
    replay's time against the full one; ``solve_multi`` at K = 16 (one
    replay, each row a single solve bit for bit, against 16 single
    replays); ``solve_batched(rhs_pattern=)`` at B = 8, each row the
    unpruned batched solve;
14. ``ac_sweep`` of the 64 × 64 grid with an AC source at node 1 over
    SPICE's ``.ac dec 10 1 1meg`` (61 points, refine=2), with the counters
    at 0: as a user calls it (the escalation ladder on) and with
    ``escalation="none"`` (one batched factorization: one batched K1 and
    one batched K3 launch in the AC phase, one K1 and one K2 launch per DC
    Newton factorization), each bit for bit the sweep with the steps one
    by one, every point within 1e-9 of scipy's ``splu``, the componentwise
    backward error at most 1e-10 at every point whose voltages stay normal
    float64 (far from the source the high frequencies decay below
    2.2e-308); its time on a warmed solver against 61 single ``GLU``
    solves; with ``static_pivot`` 1e-10 (the complex robust batched K1 in
    the graph, the same voltages) and 0.99 (bumps fire), (F,) bump counts
    equal to the steps one by one, and the robust batched K1 on the path's
    recorded run against its plain version and the library route;
15. the paper's evidence on grid64 and rajat12_like (plans from the
    cache): (a) on the host, the seconds and edge counts of
    ``levelize_relaxed`` and the relaxed, U-pattern (GLU1.0), exact and
    double-U (GLU2.0) detectors, ``upattern ∪ doubleu ⊇ exact`` and
    ``relaxed ⊇ exact``, the relaxed levels equal to the plan's, the
    levels' modes and ``level_stats`` maxima; (b) Table III on the card:
    the factorizer as planned, with ``disable_modes`` ``("flat",)``,
    ``("panel",)`` and ``("segmented", "panel")``, and with
    ``mode_override="flat"``, each with the counters at 0: its steps, K1
    and K2 launches per factorization, replay and step times, device
    kernels and busy share, a solve's residual < 1e-9, the replay bit for
    bit the steps one by one, factors within 1e-10 of the default's;
    grid64's ``noflat`` K1 run (160 levels) held bit for bit against its
    plain version and timed as a kernel entry (``"variant": "noflat"``);
    (c) ``GLU(verify="full")``: a clean report that includes the CUDA-graph
    audit, its host seconds, factors and solutions bit for bit those of
    ``GLU(verify="off")``, and ``AUDIT_DISPATCH`` with
    ``jit_schedule=False``;
16. (a) scenario-sharded sweeps: ``make_sweep_mesh()`` over the machine's
    cards (one card: ``n_devices == 1``), then grid64 and rajat12_like at
    B = 16 and B = 7 (padded) on an emulated mesh of the card repeated 4
    times, rajat12_ac at B = 8 frequencies and grid64 with
    ``static_pivot=0.6`` at B = 4 on 2: every row bit for bit the
    unsharded batch's, one factorization and one solve replay a shard,
    ``n_perturbed_global`` the padded batch's bumps; per-call times of
    both, labelled "emulated (one card)", and the peak device memory;
    ``transient_sweep(mesh=)`` of 4 copies of the 64 × 64 grid bit for bit
    the unsharded sweep; (b) grid64 through ``write_matrix_market`` and
    ``read_matrix_market`` (same pattern and values), solved to residual
    < 1e-9; (c) the on-disk ``PlanCache``: grid64 cold then warm from a
    second cache on the directory (``disk_hits == 1``, same digest), and
    rajat12_like's plan from phase 4 written and read back, against its
    build seconds; (d) ``multi_domain_circuit()`` (n = 6,400) solved to
    residual < 1e-9, and a one-node ``rhs_pattern`` in a 400-node domain:
    levels and device kernels kept, pruned and full replay times, bit for
    bit; (e) ``leftlooking_numpy`` on grid64's filled pattern within 1e-10
    of the card's factors, with its host seconds; (f) ``python -m
    repro_torch.launch.simulate --nx 16 --ny 16 --t-end 0.02 --dt 0.005``
    in a subprocess: exit 0, residual < 1e-9 (it runs at once with the
    serving CLIs of phases 17-19 and phase 21 (a)'s dry-run processes,
    each in a process of its own and judged in its phase);
17. the LM serving path (plain PyTorch, no kernel of its own): (a)
    qwen2.5-3b at full width in bfloat16 from the port's seeded init,
    ``ServeEngine.generate_batch`` at B = 4, prompt 128, 32 new tokens:
    prefill ms and decode ms a step (CUDA events, medians) beside their
    bounds, tokens/s, the path's peak device memory (over what earlier
    phases hold), and one prefill's and one decode step's device kernels
    and busy time; a second call gives the same tokens; (b) the same model in float32 with TF32 off: a prefill of 62
    tokens and 2 decode steps within 3e-4 of ``forward_train``'s last three
    positions (the reference's own bar), the same argmax; (c)
    ``ServeEngine.run`` on 6 requests, every third extending the previous
    (as ``launch/serve.py`` builds them): each child served after its
    parent, each output equal to ``generate_batch`` on its group's spliced
    prompts (and how many rows equal their prompt alone); (d) the reduced
    qwen config with the same float32 parameters on the card and on the
    CPU: logits within 1e-4, the same greedy tokens; (e) phi-3-vision-4.2b
    (prompt 300 over its 256 patch tokens) and whisper-base (frames of
    (2, 1500, 512)) at full width in bfloat16: one ``generate_batch`` each,
    finite logits, prefill and decode ms; (f) ``python -m
    repro_torch.launch.serve --arch qwen2.5-3b --reduced --batch 4
    --prompt-len 32 --max-new 16`` in a subprocess: exit 0;
18. MLA attention and the sort-based MoE (plain PyTorch, no kernel of
    their own): (a) deepseek-v2-lite-16b at full width and depth (27
    layers) in bfloat16 from the seeded init, the published capacity
    factor 1.25, ``generate_batch`` at B = 4, prompt 128, 32 new tokens,
    twice with equal tokens: prefill ms and decode ms a step beside their
    bounds (bytes with all weights, which the capacity dispatch reads, and
    with the experts the step's routers chose; matmul operations at the
    bf16 peak), tokens/s, peak memory, one prefill's and one decode step's
    device kernels and busy time, the prefill's dropped assignments; (b)
    the same weights at the dropless capacity factor E / K: bf16 prefill
    + 4 decode steps on (a)'s prompts within the bar of bf16
    ``forward_train`` and two planted faults (shared experts skipped,
    ``krope`` one slot late) above it, a third (a position late) read;
    (c) float32 at full width and depth (62.8 GB), TF32 off, dropless:
    within 3e-4 of ``forward_train``, the three faults above it; (d) reduced deepseek, reduced mixtral and reduced
    deepseek with a capacity that drops, card against CPU in float32:
    logits within 1e-4, equal aux, drop counts and greedy tokens, drops >
    0 in the last; (e) mixtral-8x7b at full width and 8 of its 32 layers
    in bfloat16: prefill and decode ms against their bounds; (f) ``python
    -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --reduced``:
    exit 0;
19. the Mamba-2 (SSD) block and its state cache (plain PyTorch, no kernel
    of its own): (a) mamba2-2.7b at full width and 32 of its 64 layers
    in bfloat16 from the seeded init, ``generate_batch`` at B = 4, prompt
    1024 (8 chunks of 128), 32 new tokens, twice with equal tokens:
    prefill ms and decode ms a step beside their bounds (bytes: the
    weights, and a decode step's float32 states read and written), tokens/s,
    peak memory, one prefill's and one decode step's device kernels and
    busy time; (b) float32 at the same width and depth, TF32 off, B = 2: a
    prefill of 1024 tokens and 128 teacher-forced decode steps within 3e-4
    of ``forward_train`` over the 1,152 tokens (9 chunks), the same
    argmax, and four planted faults above the bar (each chunk reading its
    own end state, a decode step without its decay, the conv history one
    slot late, the ``D`` skip dropped; each read over the prefill's last
    position and 8 decode steps); (c) (a)'s bf16 weights and prompts with
    128 teacher-forced decode steps against bf16 ``forward_train`` within
    the bar (1.0) and three faults above it (bf16 noise hides the chunk
    fault, which (b) holds); (d) reduced mamba2 and
    reduced jamba (8 layers), card against CPU in float32 over two chunks
    (``forward_train`` and a prefill of 256 tokens, 8 decode steps):
    logits within 1e-4, equal greedy tokens and MoE drop counts; and
    ``ssd_chunked`` alone at mamba2's heads over two chunks in float32
    against the float64 per-step recurrence within 1e-4 of max |y|, the
    chunk fault above it; (e) jamba-v0.1-52b at
    full width and 8 of its 32 layers (one period: Mamba at 0-3 and 5-7,
    attention at 4, MoE at the odd layers) in bfloat16 at the published
    capacity factor, B = 4, prompt 1024, 32 new tokens: prefill and
    decode ms against their bounds (all weights, and the experts the step
    routed to), dropped assignments, peak memory, kernels and busy time;
    then in float32 at the dropless capacity factor E / K: a prefill of
    256 tokens and 128 decode steps within 3e-4 of ``forward_train`` over
    384; (f) ``python -m repro_torch.launch.serve --arch ... --reduced``
    for both: exit 0;
20. the training path (plain PyTorch and autograd, no kernel of its
    own): (a) qwen2.5-3b at full width and 6 of its 36 layers in
    bfloat16 from the seeded init, AdamW, remat "full", B = 8, S = 512, 6 steps on
    ``TokenPipeline(seed=0)``'s batches: step ms (CUDA events, median of
    steps 2-6) beside its bound (the matmuls' operations, remat's
    recomputed forward and the optimizer's bytes, each on its own),
    tokens/s, peak memory, one more step's device kernels and busy time;
    finite losses and gradient norms, parameters that moved; (b) reduced
    qwen, mixtral, mamba2 and jamba in float32 with remat on, card
    against CPU: the loss, every gradient leaf (over its largest entry)
    and the parameters after 2 AdamW steps within 1e-4; (c) qwen2.5-3b in
    float32 at full width and depth, B = 1, S = 128: autograd's
    derivative along the unit gradient against a central difference of
    the loss (Richardson-extrapolated), within the bar, and two planted
    faults (the tied head's gradient dropped, one layer's gradient
    zeroed) above it; (d) (a)'s state saved after step 3 (zlib, stored),
    restored into a fresh model and optimizer, steps 4-6 again: losses
    and parameters bit for bit the run that never stopped, with the write
    and restore seconds and the bytes; (e) mamba2-2.7b at full width and
    depth in bfloat16, B = 4, S = 512 (four chunks), 3 AdamW steps: step
    ms against its bound, peak memory (the launcher and its resume are
    phase 22 (a)'s one-process runs);
21. the dry run (no kernel, no card: fake tensors on fake process
    groups): (a) ``python -m repro_torch.launch.dryrun`` over every arch
    at train_4k and decode_32k on the 16x16 mesh, in four processes at
    once: every cell ok, each cell's dominant term, its three terms (H100
    constants, not measured) and its per-card argument and temp bytes;
    (b) phase 20's qwen2.5-3b step (bf16, AdamW, B = 8, S = 512) as a cell
    on a 1 x 1 mesh: its argument bytes within 1 % of what the card
    allocated for the model and AdamW's moments, its temp bytes beside
    the step's measured peak over them, its bound beside
    ``_train_bounds``' and the measured step;
22. the training step on a mesh of ranks (no kernel), under the
    reference's rules (``make_rules(cfg)``: qwen2.5-3b, deepseek and
    jamba shard the sequence over ``model``): (a) qwen2.5-3b at
    full width and 4 of its 36 layers, and mamba2-2.7b at full width and
    4 of its 64, B = 8, S = 512, AdamW, 3 steps, each
    through ``python -m repro_torch.launch.train`` alone and under
    ``torch.distributed.run`` (in four lanes of runs at once) on
    meshes 2 x 1 and 1 x 2 (one rank a card
    over NCCL; on one card a 1 x 1 NCCL mesh and a line that says no
    collective crossed ranks), in float32 (losses 1e-5, parameters after
    the steps 2e-3, from the checkpoints, and each leaf's gap within 0.1
    of the one-process run's own change from the initial parameters) and
    bf16 (losses 1e-2) against the one-process run; each rank's allocation
    for the model and its moments within 1 % of ``cell_memory`` on a
    ``MeshShape`` of its mesh (for the run's own batch and sequence),
    its step times and peak memory; a 1 x 1 mesh is one process bit for
    bit in float32 (histories and every parameter leaf); one
    process resumes qwen's first mesh's checkpoint ("resumed from step
    3"); after them whisper-base at full depth (6 + 6), phi-3-vision-4.2b
    and stablelm-3b at 4 layers and mixtral-8x7b at 1 (in three lanes,
    mixtral's runs one at a time), float32 on the same meshes against
    their one-process runs (the same float32 bars, gradient norms 1e-5
    too, each leaf's bytes hashed and up to ``MESH_SAMPLES`` of its
    entries compared where qwen's and mamba2's checkpoints give whole
    leaves); (b) with 4 cards or more, bf16, 3 steps:
    deepseek-v2-lite-16b at full width and depth on 2 x 2, qwen2.5-3b at
    full depth on 2 x 2 and 4 x 1, jamba-v0.1-52b at one 8-layer period,
    nemotron-4-340b at 1 of 96 layers (2 did not fit a card),
    mixtral-8x7b at 8 of 32 over S = 5120 (B = 4: its band active),
    phi-3-vision-4.2b, whisper-base and stablelm-1.6b at full depth, all
    on 2 x 2: per card step ms, peak memory and the allocation against
    ``cell_memory`` (left out, and said so, on fewer cards).

23. complex values in the native layout (the JAX package's default
    complex route; every level a flat step, the dense tail on K3), run
    after phase 16 while the plan cache still holds rajat12's plan:
    ``GLU(rajat12_ac, dtype=complex128, layout="native")`` with the
    counters at 0, no K1 and one K3 launch a factorization over the
    refactorizations, replays bit for bit the steps one by one, factors
    within 1e-12 of the planar route's (relative to the largest factor
    entry), the refined residual < 1e-9, K3 on this route's recorded tile
    against its plain version; B = 8 frequencies batched (one K3 launch a
    batched factorization, each matrix's residual < 1e-9, the replay bit
    for bit the steps one by one and each row one ``GLU``'s); phase 14's
    ``ac_sweep`` with ``layout="native"`` (``escalation="none"``: one
    batched factorization, no K1 and one K3 launch in the AC phase): every
    point within 1e-9 of scipy's ``splu`` and within 1e-12 of the planar
    sweep relative to the point's largest voltage, bit for bit the sweep
    with the steps one by one; replay times of both layouts'
    factorizations and solves;
24. the six examples (``examples/torch_*.py``) in this process on the
    card at their defaults (the training example's checkpoints and
    metrics in a temporary directory under ``build/``), each example's
    lines printed.

Phase 7 also drives ``GLU(rajat12_ac, static_pivot=...)`` (the complex
robust K1 inside the graph, bump counts equal to the steps one by one) and
times the complex robust K1 on its recorded run with the diagonals crushed
below tau.

The line before the last is ``{"kernels": [...]}``, one entry per kernel
and matrix, over all matrices (the batched ones with ``batch``, phase 15's
with ``variant``); the last
line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the FP64 tensor /
# FP32 non-tensor rates.  Bounds below are stated against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}

K2_TOL = {"float32": 5e-3, "float64": 1e-9}   # K3 too, on its planes
# K2's and K3's componentwise backward error max |LU - A| / (|L| |U|), in
# units of N times the plane dtype's epsilon: catches a wrong L whose
# entries lie below K2_TOL (on the test tiles they are about 1/N)
K2_BWD = 4.0

# (matrix, expected K1, K2 and K3 launches per factorization); the counts
# are the schedules' own, checked again here: each matrix's K1 levels
# (grid64 154, rajat12_like 10) are one run, one launch.  rajat12_ac is
# ac_jacobian(1879, avg_degree=6.9, seed=0): rajat12_like's exact pattern
# with complex values, so it plans into the same schedule
MATRICES = [("grid64", 1, 1, 0), ("rajat12_like", 1, 1, 0),
            ("rajat12_ac", 1, 0, 1)]
# K1 runs of phase 3: (label, one (D, R, C) per level, all positions on
# one slot)
K1_RUNS = [("grid64 widest levels", [(905, 90, 297), (710, 135, 297),
                                     (392, 199, 297), (56, 40, 150)], False),
           ("rajat12_like maxima", [(801, 2355, 794), (723, 1200, 794)], False),
           ("split rows (C > 1024)", [(3, 768, 2100), (4, 300, 1100)], False),
           ("all-duplicate positions", [(64, 2355, 128)], True),
           ("one level", [(1, 90, 270)], False)]
N_REFACTOR = 5
# static pivoting: the ladder's bump rung threshold, and one large enough
# that bumps fire on grid64's scaled values
PIVOT_EPS = 1e-10
PIVOT_EPS_BUMPS = 0.6
# complex matrices keep every pivot above 0.6 max|A| after MC64 scaling
# (rajat12_ac): a threshold at which bumps fire on them
PIVOT_EPS_BUMPS_AC = 0.99
# the transient phase: the G3_circuit-like grid at grid64's width
TRANSIENT = dict(nx=64, ny=64, t_end=0.1, dt=5e-3, refine=1)
AC_OMEGAS = np.logspace(2.5, 3.5, N_REFACTOR)   # rad/s, around the plan's 1e3
# the batched engine: batch sizes per matrix, rajat12_ac's frequencies
# (log10 rad/s), the static-pivot batch, and the lockstep transient sweep
BATCHES = {"grid64": (1, 16), "rajat12_like": (1, 16), "rajat12_ac": (8,)}
BATCH_AC_OMEGAS = (2.5, 3.5)
PIVOT_BATCH = 4
# phase 13: many right-hand sides and the batch of a pruned batched solve
MULTI_K = 16
PATTERN_BATCH = 8
# phase 14: SPICE's ".ac dec 10 1 1meg" (ten points a decade, 1 Hz to
# 1 MHz) on the transient phase's grid, one AC current source at node 1
AC_SWEEP = dict(nx=64, ny=64, node=1, decades=(0, 6), points=61, refine=2)
SWEEP = dict(nx=64, ny=64, t_end=0.05, dt=5e-3, refine=1,
             scales=np.linspace(0.8, 1.2, 8))
SEED = 1234
# seconds of timed calls a measurement spends at most, beyond its warm-up
# (the plain versions of the batched robust K1 take ~10 s a call)
TIMING_BUDGET_S = 5.0


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def compare(got, want, tol: float) -> float:
    """Assert kernel == plain version within ``tol`` (NaN where the plain
    version has NaN: main-path inputs read the trash slot at padded
    positions) and return the largest absolute difference elsewhere."""
    torch.testing.assert_close(got, want, rtol=tol, atol=tol, equal_nan=True)
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return (got[fin] - want[fin]).abs().max().item()


class Clock:
    """Device time with CUDA events: ``ms(fn, reps)`` is the mean time of
    one ``fn()`` over ``reps`` back-to-back calls after one warm-up call."""

    def __init__(self, device):
        self.device = device

    def ms(self, fn, reps: int = 10) -> float:
        """A call whose warm-up took more than ``TIMING_BUDGET_S / reps``
        runs as many times as ``TIMING_BUDGET_S`` holds, once at least."""
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(self.device)
        warm = time.perf_counter() - t0
        if warm > 0:
            reps = max(1, min(reps, int(TIMING_BUDGET_S / warm)))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(stop) / reps

    def median_ms(self, fn, reps: int = 7) -> float:
        """Median of single-call times (host clock around a synchronised
        call): the time a caller waits for one call."""
        fn()
        torch.cuda.synchronize(self.device)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(self.device)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)


def check_kernels_at_shapes(dev) -> None:
    """Phase 3: kernel against plain version on random inputs at the main
    path's shapes: K1 on the runs of ``K1_RUNS`` in all four value dtypes,
    bit for bit and repeated bit for bit; K2 at N=160 (grid64) and N=736
    (rajat12_like), K3 at N=736 (rajat12_ac) and N=96, K2 and K3 at one
    block, N=32, and at N=1024; K2 at N=2048, more update blocks than
    resident CTAs.  K2 and K3 are also held to their backward error, which
    a wrong L cannot pass, and must leave ``a`` unchanged and repeat bit
    for bit."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.level_update import random_level_run

    rng = np.random.default_rng(SEED)
    for dtype in (torch.float64, torch.float32, torch.complex128,
                  torch.complex64):
        name = str(dtype).split(".")[-1]
        for label, shapes, dups in K1_RUNS:
            run, vals = random_level_run(rng, shapes, dtype, dev,
                                         duplicates=dups)
            got, again, want = vals.clone(), vals.clone(), vals.clone()
            kernels.level_run(got, run)
            kernels.level_run(again, run)
            torch.cuda.synchronize(dev)
            ref.level_run_ref(want, run)
            torch.cuda.synchronize(dev)
            assert not torch.equal(got, vals), (label, name, "unchanged")
            assert torch.equal(got, want), (
                label, name, (got - want).abs().max().item())
            assert torch.equal(again, got), (label, name, "repeat")
            log(f"check K1 {name} {label} ({len(shapes)} levels, max D "
                f"{max(s[0] for s in shapes)}, R {max(s[1] for s in shapes)}, "
                f"C {max(s[2] for s in shapes)}): bit-identical to the plain "
                "version, repeat bit-identical ok")
    for dtype in (torch.float64, torch.float32, torch.complex128,
                  torch.complex64):
        name = str(dtype).split(".")[-1]
        real = torch.empty(0, dtype=dtype).real.dtype
        for label, shapes, dups in K1_RUNS:
            run, vals = random_level_run(rng, shapes, dtype, dev,
                                         duplicates=dups)
            fresh = vals.clone()
            n_crushed = crush_diagonals(rng, run, vals)
            tau = torch.tensor(1e-3, dtype=real, device=dev)
            outs = []
            for fn in (kernels.level_run, kernels.level_run,
                       ref.level_run_ref):
                v = vals.clone()
                count = torch.zeros((), dtype=torch.int32, device=dev)
                fn(v, run, tau, count)
                torch.cuda.synchronize(dev)
                outs.append((v, int(count)))
            (got, n), (again, n2), (want, n_want) = outs
            assert n == n2 == n_want == n_crushed, (label, name, n, n_want)
            assert torch.equal(got, want), (
                label, name, "robust", (got - want).abs().max().item())
            assert torch.equal(again, got), (label, name, "robust repeat")
            log(f"check K1 robust {name} {label}: {n} bumps in "
                f"{len(shapes)} level(s) (tau 1e-3), bit-identical to the "
                "plain version with equal counts, repeat bit-identical ok")
            if not dtype.is_complex:
                continue
            # B = 4 with per-matrix tau; the last matrix crushed less
            # (below 1e-3) against tau 1e-5, so that only some of its
            # crushed diagonals bump.  A level's diagonals are not written
            # before its bump, so the counts are those of the values given
            batch = torch.stack([fresh] * PIVOT_BATCH)
            for b in range(PIVOT_BATCH):
                crush_diagonals(rng, run, batch[b],
                                below=1e-3 if b == PIVOT_BATCH - 1 else 1e-6)
            tau = torch.tensor([1e-3] * (PIVOT_BATCH - 1) + [1e-5],
                               dtype=real, device=dev)
            diag = torch.from_numpy(run.host["diag"]).to(dev)
            d = batch[:, diag]
            mag = (torch.hypot(d.real, d.imag) if d.is_complex()
                   else d.abs())
            expected = (mag < tau[:, None]).sum(-1).tolist()
            outs = []
            for fn in (kernels.level_run, kernels.level_run,
                       ref.level_run_ref):
                v = batch.clone()
                count = torch.zeros(PIVOT_BATCH, dtype=torch.int32,
                                    device=dev)
                fn(v, run, tau, count)
                torch.cuda.synchronize(dev)
                outs.append((v, count.tolist()))
            (got, n), (again, n2), (want, n_want) = outs
            assert n == n2 == n_want == expected, (label, name, n, expected)
            assert torch.equal(got, want) and torch.equal(again, got), (
                label, name, "robust batched")
            log(f"check K1 robust batched {name} {label}: B={PIVOT_BATCH}, "
                f"bumps a matrix {n} (tau 1e-3, last 1e-5), bit-identical "
                "to the plain version with equal counts, repeat "
                "bit-identical ok")
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for label, kernel, plain, sizes, planes in (
                ("K2", kernels.dense_lu, ref.dense_lu_ref,
                 (32, 160, 736, 1024, 2048), ()),
                ("K3", kernels.dense_lu_planar, ref.dense_lu_planar_ref,
                 (32, 96, 736, 1024), (2,))):
            for N in sizes:
                a = torch.from_numpy(rng.normal(size=(*planes, N, N))).to(
                    dev, dtype)
                (a[0] if planes else a).add_(
                    N * torch.eye(N, dtype=dtype, device=dev))
                a0 = a.clone()
                got = kernel(a)
                again = kernel(a)
                torch.cuda.synchronize(dev)
                want = plain(a)
                torch.cuda.synchronize(dev)
                err = compare(got, want, K2_TOL[name])
                bwd = ref.lu_backward_error(a, got)
                bwd_tol = K2_BWD * N * torch.finfo(dtype).eps
                assert bwd <= bwd_tol, (label, name, N, bwd, bwd_tol)
                assert torch.equal(a, a0), (label, name, N, "a modified")
                assert torch.equal(again, got), (label, name, N, "repeat")
                log(f"check {label} {name}{' planes (complex)' if planes else ''}"
                    f" N={N}: max_abs_err={err:.3e} tol={K2_TOL[name]:g}; "
                    f"backward error {bwd:.3e} <= {bwd_tol:.3e}; a unchanged, "
                    "repeat bit-identical ok")


def crush_diagonals(rng, run, vals, below: float = 1e-6) -> int:
    """Crush up to 5 of each level's column diagonals below ``below`` in
    magnitude, so that static pivoting bumps them in every level: real
    values drawn from (-below, below), complex ones scaled to a magnitude
    in [0, below) with their phase kept, every seventh an exact zero.
    Returns how many."""
    h = run.host
    picks = []
    for k in range(run.n_levels):
        d = h["diag"][h["diag_ptr"][k]:h["diag_ptr"][k + 1]]
        picks.append(rng.choice(d, size=min(5, len(d)), replace=False))
    picks = torch.from_numpy(np.concatenate(picks)).to(vals.device)
    mag = torch.from_numpy(rng.uniform(-below, below, size=len(picks))).to(
        vals.device, vals.real.dtype)
    if vals.is_complex():
        mag = mag.abs()
        mag[::7] = 0.0
        vals[picks] = vals[picks] / vals[picks].abs() * mag
    else:
        vals[picks] = mag
    return len(picks)


def make_matrix(name):
    from repro_torch.sparse import ac_jacobian, make_suite_matrix

    if name == "rajat12_ac":
        return ac_jacobian(1879, avg_degree=6.9, seed=0)
    return make_suite_matrix(name, 1.0)


def refactor_values(name, A, rng):
    """Values for the refactorizations on A's pattern: other frequencies of
    the AC matrix, Newton-like iterates of a real one."""
    from repro_torch.sparse import ac_jacobian

    if name == "rajat12_ac":
        return [ac_jacobian(1879, omega=w, avg_degree=6.9, seed=0).data
                for w in AC_OMEGAS]
    return [newton_values(A, rng) for _ in range(N_REFACTOR)]


def newton_values(A, rng):
    """A Newton-like iterate on A's pattern: off-diagonal conductances move
    by up to 10%, diagonals grow by 10-20% (diagonal dominance holds)."""
    cols = np.repeat(np.arange(A.n), np.diff(A.indptr))
    diag = A.indices == cols
    scale = np.where(diag, rng.uniform(1.1, 1.2, size=A.nnz),
                     rng.uniform(0.9, 1.1, size=A.nnz))
    return np.asarray(A.data) * scale


def reset_counts():
    from repro_torch.kernels import COUNTED

    for k in COUNTED:
        k.launches = 0


def launch_counts():
    from repro_torch.kernels import dense_lu, dense_lu_planar, level_run

    return level_run.launches, dense_lu.launches, dense_lu_planar.launches


def record_kernel_inputs(g, a_data, batched: bool = False):
    """Factorize ``a_data`` ((B, nnz) with ``batched``) with ``g``'s steps
    one by one (``g``, a ``GLU`` or a ``TorchFactorizer``, has
    ``jit_schedule=False``), recording each kernel's input: K1's value
    array just before each run (with the run, and tau and the count buffer
    under static pivoting), each dense tile (or batch of tiles) for K2 and
    K3."""
    import repro_torch.core.factorize as factorize_mod

    fz = getattr(g, "_factorizer", g)
    assert fz._graph is None
    rec = {"k1": [], "k2": [], "k3": []}
    real = {"k1": fz._step["run"], "k1_robust": factorize_mod.level_run,
            "k2": factorize_mod.dense_lu, "k3": factorize_mod.dense_lu_planar}

    def k1_recorder(vals, run, *robust):
        rec["k1"].append((vals.clone(), run,
                          tuple(t.clone() for t in robust)))
        return real["k1"](vals, run, *robust)

    def tile_recorder(key):
        def record(a):
            rec[key].append(a.clone())
            return real[key](a)
        return record

    fz._step["run"] = k1_recorder
    factorize_mod.level_run = k1_recorder
    factorize_mod.dense_lu = tile_recorder("k2")
    factorize_mod.dense_lu_planar = tile_recorder("k3")
    try:
        (g.factorize_batched if batched else g.factorize)(a_data)
    finally:
        fz._step["run"] = real["k1"]
        factorize_mod.level_run = real["k1_robust"]
        factorize_mod.dense_lu = real["k2"]
        factorize_mod.dense_lu_planar = real["k3"]
    torch.cuda.synchronize()
    return rec


def drive_matrix(dev, clock, name, want_k1, want_k2, want_k3):
    """Phases 4-6 for one matrix.  Returns the matrix's report, the kernels'
    inputs recorded from one factorization, and the two GLUs (replays, and
    the steps one by one)."""
    from repro_torch import GLU
    from repro_torch.core import plan_factorization

    A = make_matrix(name)
    cplx = np.iscomplexobj(A.data)
    dtype = torch.complex128 if cplx else torch.float64
    t0 = time.perf_counter()
    # fills the process-wide plan cache; rajat12_ac's MC64 matching equals
    # rajat12_like's, so it reuses that plan, as an AC sweep after a
    # transient run on the same circuit would
    _, _, from_cache = plan_factorization(A)
    plan_s = time.perf_counter() - t0
    log(f"{name}: n={A.n} nnz={A.nnz} {dtype} planning {plan_s:.3f} s "
        f"(host numpy, plan from cache: {from_cache})")
    rng = np.random.default_rng(SEED)
    b = rng.normal(size=A.n)
    if cplx:
        b = b + 1j * rng.normal(size=A.n)

    # -- the path: counters at 0 just before, read just after ---------------
    reset_counts()
    t0 = time.perf_counter()
    g = GLU(A, dtype=dtype)
    build_s = time.perf_counter() - t0
    g.factorize()
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    x = g.solve(b)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    k1, k2, k3 = launch_counts()
    first_s = dict(factorize=t1 - t0 - build_s, solve=t2 - t1)
    fz = g._factorizer
    kinds, steps = fz.kinds, fz.step_kinds
    info = g.solve_info
    runs = [gr.arrays[0] for gr in fz._groups if gr.kind == "run"]
    work = dict(
        planes=2 if cplx else 1,
        k1_levels=kinds.count("pallas"), k1_runs=len(runs),
        k1_updates=sum(r.n_updates for r in runs),
        k1_rows=sum(len(r.host["rows"]) for r in runs),
        tail_sizes=[fz.dense_tail_info["size"]] if fz.dense_tail_info else [])
    n_dense = steps.count("dense")
    log(f"{name}: path K1 launches={k1} ({work['k1_levels']} K1 levels in "
        f"{len(runs)} run(s), expected {want_k1} launch(es)), K2 launches={k2} "
        f"(expected {want_k2}), K3 launches={k3} (expected {want_k3}; dense "
        f"groups {n_dense}), levels={g.num_levels}, steps of the first "
        f"(warm-up) factorization {info['n_dispatches']} ({len(steps)} "
        f"groups: {steps.count('flat')} flat), nnz_filled={g.nnz_filled}, "
        f"layout={info['layout']}, dense_tail={fz.dense_tail_info}")
    assert k1 == len(runs) == want_k1, (k1, want_k1)
    assert k2 == want_k2 and k3 == want_k3 and k2 + k3 == n_dense, (k2, k3)
    assert info["kernels_disabled_reason"] is None, info
    assert info["layout"] == ("planar" if cplx else "native"), info
    assert fz._graph is not None and fz._graph.graph is not None
    res0 = g.residual(b, x)
    assert np.isfinite(x).all() and x.shape == (A.n,) and res0 < 1e-9, res0
    log(f"{name}: solve residual={res0:.3e}; GLU build {build_s:.3f} s; "
        f"first factorize {first_s['factorize']:.3f} s and first solve "
        f"{first_s['solve']:.3f} s (steps one by one, then the capture)")

    # -- refactorizations: replays against the steps one by one -------------
    ge = GLU(A, dtype=dtype, jit_schedule=False)
    S = A.to_scipy()
    vals_set = refactor_values(name, A, rng)
    for i, new in enumerate(vals_set):
        before = launch_counts()
        x = g.factorize(new).solve(b)
        after = launch_counts()
        disp = (g.solve_info["n_dispatches"], g.solve_info["solve_dispatches"])
        xe = ge.factorize(new).solve(b)
        assert disp == (1, 1), disp
        assert (after[0] - before[0], after[1] + after[2] - before[1]
                - before[2]) == (len(runs), n_dense), (before, after)
        assert torch.equal(g.factorized_values(), ge.factorized_values()), i
        assert x.tobytes() == xe.tobytes(), i
        S.data = new
        res = float(np.abs(S @ x - b).max() / np.abs(b).max())
        assert np.isfinite(x).all() and res < 1e-9, (i, res)
        log(f"{name}: refactorization {i}: one replay each for factorize "
            f"and solve, bit-identical to the steps one by one "
            f"({ge.solve_info['n_dispatches']} and "
            f"{ge.solve_info['solve_dispatches']} steps); residual="
            f"{res:.3e} < 1e-9 ok")
    x2 = g.solve(b, refine=2)
    rinfo = g.solve_info
    assert rinfo["converged"] and np.isfinite(x2).all(), rinfo
    assert x2.tobytes() == ge.solve(b, refine=2).tobytes()
    assert ge.solve_info["refine_iters"] == rinfo["refine_iters"]
    log(f"{name}: refine=2 backward_error={rinfo['backward_error']:.3e} "
        f"iters={rinfo['refine_iters']} residual="
        f"{float(np.abs(S @ x2 - b).max() / np.abs(b).max()):.3e}, "
        f"{rinfo['solve_dispatches']} dispatches (replays, reads and the "
        f"|A| pass), bit-identical to the steps one by one")

    # -- bit-identical repeat ---------------------------------------------------
    v1 = g.factorize(vals_set[0]).factorized_values()
    v2 = g.factorize(vals_set[0]).factorized_values()
    x1 = g.solve(b)
    x2 = g.solve(b)
    assert torch.equal(v1, v2) and np.array_equal(x1, x2)
    log(f"{name}: two factorizations and solves of the same values are "
        "bit-identical")

    # -- record the kernels' inputs from one factorization ------------------
    rec = record_kernel_inputs(ge, vals_set[0])

    # -- timings ----------------------------------------------------------------
    bp = torch.as_tensor((b * g.Dr)[g._inv_row], dtype=g.dtype, device=dev)
    fze = ge._factorizer
    fact_ms = clock.ms(fz.run, reps=20)
    fact_eager_ms = clock.ms(fze.run, reps=10)
    solve_ms = clock.ms(lambda: g._solver.solve(g._vals, bp), reps=20)
    solve_eager_ms = clock.ms(lambda: ge._solver.solve(ge._vals, bp), reps=5)
    fact_call_ms = clock.median_ms(lambda: g.factorize(vals_set[1]))
    solve_call_ms = clock.median_ms(lambda: g.solve(b))
    fact_call_eager_ms = clock.median_ms(lambda: ge.factorize(vals_set[1]))
    solve_call_eager_ms = clock.median_ms(lambda: ge.solve(b), reps=3)
    report = dict(
        matrix=name, dtype=str(dtype), n=A.n, nnz=A.nnz,
        nnz_filled=g.nnz_filled, levels=g.num_levels, groups=len(kinds),
        planning_s=plan_s, plan_from_cache=from_cache, glu_build_s=build_s,
        first_call_s=first_s,
        k1_launches=k1,
        k2_launches=k2, k3_launches=k3, refine2=dict(
            iters=rinfo["refine_iters"],
            backward_error=rinfo["backward_error"],
            dispatches=rinfo["solve_dispatches"]),
        factorize_dispatches=1, solve_dispatches=1,
        eager_factorize_steps=ge.solve_info["n_dispatches"],
        eager_solve_steps=ge._solver.last_n_dispatches,
        factorize_step_kinds=steps,
        factorize_ms=fact_ms, solve_ms=solve_ms,
        eager_factorize_ms=fact_eager_ms, eager_solve_ms=solve_eager_ms,
        factorize_call_ms=fact_call_ms, solve_call_ms=solve_call_ms,
        eager_factorize_call_ms=fact_call_eager_ms,
        eager_solve_call_ms=solve_call_eager_ms,
        refactor_residual_max="< 1e-9", **work)
    log(f"{name}: factorize {fact_ms:.4f} ms one replay, {fact_eager_ms:.4f} "
        f"ms steps one by one; solve {solve_ms:.4f} ms one replay, "
        f"{solve_eager_ms:.3f} ms steps one by one (CUDA events, values on "
        f"the card); GLU.factorize call median {fact_call_ms:.3f} / "
        f"{fact_call_eager_ms:.3f} ms, GLU.solve call median "
        f"{solve_call_ms:.3f} / {solve_call_eager_ms:.3f} ms (replays / "
        "steps one by one)")
    return report, rec, g, ge


def _bound(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S["float64"] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_entries(dev, clock, rec, report):
    """Time each kernel the matrix's path ran, its plain version and the
    library yardstick on the recorded path inputs; compute bounds from the
    real (unpadded) work of those inputs."""
    out = []
    if rec["k1"]:
        out.append(_k1_entry(dev, clock, rec["k1"], report))
    if rec["k2"]:
        out.append(_tile_entry(clock, rec["k2"], report, planar=False))
    if rec["k3"]:
        out.append(_tile_entry(clock, rec["k3"], report, planar=True))
    for e in out:
        e["matrix"] = report["matrix"]
    return out


# the JAX package's functions that reach K1's pallas_call, by value kind
# and batch: (name of the entry, file:line of the function)
K1_SITES = {(False, False): ("level_run", "src/repro/kernels/level_update.py:60"),
            (True, False): ("level_run", "src/repro/kernels/level_update.py:60"),
            (False, True): ("level_run_batched", "src/repro/kernels/ops.py:86"),
            (True, True): ("level_run_batched", "src/repro/kernels/ops.py:173")}


def _k1_bound(run, esize: int, planes: int, n_bumped=None, batch: int = 1):
    """Bytes and operations one run needs on its real data: each layout
    index read once (a batch shares them), each value it reads (operands,
    segments' touched slots, normalized entries and their diagonals) read
    once and each slot it writes written once, in every matrix; a real
    update is a divide, a multiply and an add, a complex one 20 real
    operations (pdiv 12, pmul 6, the add 2), a normalization one division
    (complex: 12).  With ``n_bumped`` (the robust instantiation, bumps over
    the batch): the diagonal lists too, each diagonal read and compared
    once, each bumped one written once."""
    h = run.host
    layout = ("levels", "items", "rows", "upd", "norm")
    diag = h["diag"] if n_bumped is not None else np.zeros(0, np.int64)
    written = run.written_slots()
    read = np.unique(np.concatenate([h["upd"][:, :3].ravel(), written,
                                     h["norm"].ravel(), diag]))
    n_written = len(np.unique(written)) + len(h["norm"])
    n_index = sum(h[k].size for k in layout)
    if n_bumped is not None:
        n_index += h["diag_ptr"].size + diag.size
    n_bytes = 4 * n_index + planes * esize * (
        batch * (len(read) + n_written) + (n_bumped or 0))
    per_upd, per_norm = (20, 12) if planes == 2 else (3, 1)
    return n_bytes, batch * (run.n_updates * per_upd + len(h["norm"]) * per_norm
                             + diag.size)


def _library_level_route(vals, levels, lib_idx, tau=None, count=None):
    """The library route of K1 on (n,) or (B, n) values: per level the eager
    steps (``perturb_diags`` first under static pivoting, normalize, the
    products) with one ``scatter_add_`` (atomics) in place of the
    fixed-order accumulation.  ``lib_idx`` holds each level's slots shaped
    for it (:func:`_library_index`)."""
    from repro_torch.kernels.ops import perturb_diags
    from repro_torch.sparse import pdiv, pmul

    cplx = vals.is_complex()
    target = torch.view_as_real(vals) if cplx else vals
    dim = vals.dim() - 1
    for (lidx, uidx, _, _, _, ni, nd, diag), slots in zip(levels, lib_idx):
        if tau is not None:
            count += perturb_diags(vals, diag, tau)[1]
        if cplx:
            vals[..., ni] = torch.view_as_complex(pdiv(
                torch.view_as_real(vals[..., ni]),
                torch.view_as_real(vals[..., nd])))
            c = -pmul(torch.view_as_real(vals[..., lidx]),
                      torch.view_as_real(vals[..., uidx]))
        else:
            vals[..., ni] = vals[..., ni] / vals[..., nd]
            c = -(vals[..., lidx] * vals[..., uidx])
        target.scatter_add_(dim, slots, c)


def _library_index(levels, v0):
    """Each level's slots expanded to the shape of its contributions on
    values like ``v0``, for :func:`_library_level_route`."""
    out = []
    for t in levels:
        slots = t[3]
        shape = v0.shape[:-1] + slots.shape + ((2,) if v0.is_complex() else ())
        view = (1,) * (v0.dim() - 1) + (-1,) + ((1,) if v0.is_complex() else ())
        out.append(slots.view(view).expand(shape).contiguous())
    return out


def _k1_entry(dev, clock, rec_k1, report):
    """K1 on the recorded run(s) of one factorization (a batch's (B, n)
    value array when the path was batched): the kernel must equal its plain
    version bit for bit, and repeat bit for bit.  Each timed call starts
    from the recorded values (a copy whose own time is measured and
    subtracted).  The yardstick is the library route: the per-level eager
    steps of the plain route with one ``scatter_add_`` (atomics) a level in
    place of the fixed-order accumulation; it is timed only."""
    from repro_torch.kernels import level_run
    from repro_torch.kernels.level_update import random_level_run
    from repro_torch.kernels.ref import level_run_ref

    bufs, n_bytes, n_ops = [], 0, 0
    for v0, run, _ in rec_k1:
        got, again, want = v0.clone(), v0.clone(), v0.clone()
        level_run(got, run)
        level_run(again, run)
        level_run_ref(want, run)
        torch.cuda.synchronize(dev)
        assert torch.equal(got, want), \
            ("K1 differs from its plain version on the path's run",
             (got - want).abs().max().item())
        assert torch.equal(again, got), "K1 repeat differs"
        bufs.append((v0, run, v0.clone(), _library_index(run.ref_levels(), v0)))
        batch = v0.shape[0] if v0.dim() == 2 else 1
        b, o = _k1_bound(run, v0.element_size() // report["planes"],
                         report["planes"], batch=batch)
        n_bytes, n_ops = n_bytes + b, n_ops + o

    def copies():
        for v0, _, buf, _ in bufs:
            buf.copy_(v0)

    def timed(fn, reps):
        def call():
            for v0, run, buf, slots in bufs:
                buf.copy_(v0)
                fn(buf, run, slots)
        return max(clock.ms(call, reps=reps) - copy_ms, 0.0)

    copy_ms = clock.ms(copies, reps=20)
    v0 = rec_k1[0][0]
    batched = v0.dim() == 2
    name, site = K1_SITES[(v0.is_complex(), batched)]
    k1 = dict(name=name, route="cuda",
              source="src/repro_torch/kernels/csrc/level_run.cu",
              replaces=site, launches=report["k1_launches"], max_abs_err=0.0,
              ms=timed(lambda v, r, s: level_run(v, r), 20),
              plain_ms=timed(lambda v, r, s: level_run_ref(v, r), 3),
              **_bound(n_bytes, n_ops),
              library_ms=timed(lambda v, r, s: _library_level_route(
                  v, r.ref_levels(), s), 10))
    k1.update(levels=report["k1_levels"], updates=report["k1_updates"],
              rows=report["k1_rows"], bytes=n_bytes, operations=n_ops,
              copy_ms=copy_ms, ratio_to_library=k1["ms"] / k1["library_ms"],
              library="per-level eager route, one scatter_add_ a level")
    extra = ""
    if batched:
        k1.update(batch=v0.shape[0], kernel_site=K1_SITES[(False, False)][1])
        extra = f", batch {v0.shape[0]}"
    else:
        # the latency floor: as many levels, each one row of one update, on
        # values of the same dtype (barriers and each level's dependent
        # loads; the values drift from call to call, which the timing does
        # not see)
        floor_run, floor_vals = random_level_run(
            np.random.default_rng(SEED), [(1, 1, 1)] * report["k1_levels"],
            v0.dtype, dev)
        k1["floor_ms"] = clock.ms(lambda: level_run(floor_vals, floor_run),
                                  reps=20)
        extra = (f"; latency floor of {k1['levels']} one-update levels "
                 f"{k1['floor_ms']:.4f} ms")
    log(f"{report['matrix']}: {name} ({k1['levels']} levels, "
        f"{k1['updates']} updates a matrix, one launch{extra}) {k1['ms']:.4f} "
        f"ms, bit-identical to the plain version ({k1['plain_ms']:.3f} ms); "
        f"library route {k1['library_ms']:.4f} ms, ms/library_ms="
        f"{k1['ratio_to_library']:.3f}; bound {k1['bound_ms']:.5f} ms "
        f"({k1['bound_by']}); copy {copy_ms:.4f} ms subtracted")
    return k1


def _tile_entry(clock, tiles, report, planar: bool):
    """K2 (real (N, N) tiles) or K3 ((2, N, N) complex planes) on the
    recorded dense-tail tile(s), or on the recorded batch(es) of tiles
    ((B, N, N), (B, 2, N, N)) of a batched path."""
    from repro_torch.kernels import dense_lu, dense_lu_planar
    from repro_torch.kernels.ref import (
        dense_lu_planar_ref,
        dense_lu_ref,
        lu_backward_error,
    )

    kernel = dense_lu_planar if planar else dense_lu
    plain = dense_lu_planar_ref if planar else dense_lu_ref
    batched = tiles[0].dim() == (4 if planar else 3)
    err = 0.0
    n_tiles = 0
    for a in tiles:
        got = kernel(a)
        err = max(err, compare(got, plain(a),
                               K2_TOL[str(a.dtype).split(".")[-1]]))
        for t, lu in zip(*((a, got) if batched else ([a], [got]))):
            bwd = lu_backward_error(t, lu)
            bwd_tol = K2_BWD * a.shape[-1] * torch.finfo(a.dtype).eps
            assert bwd <= bwd_tol, ("path tile", planar, bwd, bwd_tol)
            n_tiles += 1
    # the real tail, not its padding to the block: each value read and
    # written once; 2m^3/3 multiply-adds as operations, a complex one being
    # 4 real multiplies and 4 adds (8m^3/3 real operations in all); a
    # batch, every tile
    esize = tiles[0].element_size()
    per = 2 if planar else 1
    reps = n_tiles // len(report["tail_sizes"])
    n_bytes = reps * sum(2 * per * m * m * esize for m in report["tail_sizes"])
    n_ops = reps * sum(per * per * 2 * m ** 3 / 3 for m in report["tail_sizes"])
    # library yardstick: one unpivoted LU call on the same tile(s), complex
    # for K3 (converted once, outside the timing)
    lib_in = [torch.complex(a.select(-3, 0), a.select(-3, 1)) if planar else a
              for a in tiles]

    def run():
        for a in tiles:
            kernel(a)

    def run_plain():
        for a in tiles:
            plain(a)

    def run_lib():
        for a in lib_in:
            torch.linalg.lu_factor(a, pivot=False)

    suffix = "_batched" if batched else ""
    if planar:
        ent = dict(name="dense_lu_planar" + suffix, route="cuda",
                   source="src/repro_torch/kernels/csrc/dense_lu_planar.cu",
                   replaces="src/repro/kernels/dense_lu.py:207",
                   launches=report["k3_launches"])
    else:
        ent = dict(name="dense_lu" + suffix, route="cuda",
                   source="src/repro_torch/kernels/csrc/dense_lu.cu",
                   replaces="src/repro/kernels/dense_lu.py:98",
                   launches=report["k2_launches"])
    ent.update(max_abs_err=err, ms=clock.ms(run),
               plain_ms=clock.ms(run_plain, reps=1 if batched else 3),
               **_bound(n_bytes, n_ops), library_ms=clock.ms(run_lib))
    ent["N"] = [int(a.shape[-1]) for a in tiles]
    ent["ratio_to_library"] = ent["ms"] / ent["library_ms"]
    if batched:
        ent["batch"] = int(tiles[0].shape[0])
        ent["also_replaces"] = ("src/repro/core/factorize.py:"
                                + ("465" if planar else "424")
                                + " (the batched tail: vmap of the XLA LU)")
    log(f"{report['matrix']}: {ent['name']} N={ent['N']}"
        f"{' B=' + str(ent['batch']) if batched else ''} {ent['ms']:.4f} ms, "
        f"library {ent['library_ms']:.4f} ms, ms/library_ms="
        f"{ent['ratio_to_library']:.3f}, bound {ent['bound_ms']:.5f} ms "
        f"({ent['bound_by']})")
    return ent


_TAIL_SPINS = 16


def _profile(dev, fn):
    """Kernel launches and device-side time of one ``fn()`` call, from
    torch.profiler; 'not measured' when it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        # Later in a run the card's profiler has lost device records of a
        # window, mostly its last ones: trailing spin kernels, left out of
        # the rows, keep the factorization's own kernels off the tail.
        for _ in range(_TAIL_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize(dev)
    rows = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue                  # host ops: their kernels are listed too
        if "spin_kernel" in evt.key:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us, evt.key, evt.count))
    if not rows:
        return {"profiler": "not measured (no device time recorded)"}
    rows.sort(reverse=True)
    return {"kernels": sum(r[2] for r in rows),
            "dense_lu_kernels": sum(r[2] for r in rows
                                    if "dense_lu_kernel" in r[1]),
            "level_run_kernels": sum(r[2] for r in rows
                                     if "level_run_kernel" in r[1]),
            "device_busy_ms": sum(r[0] for r in rows) / 1e3,
            "top": [{"name": k[:70], "device_ms": t / 1e3, "count": c}
                    for t, k, c in rows[:6]]}


def _profile_until(dev, fn, want, tries=8):
    """``_profile(dev, fn)`` until its window shows the expected count of
    each kernel in ``want`` (``{"dense_lu_kernels": n, ...}``).  The
    profiler loses device records (see ``_profile``) but never adds any: a
    window that shows more than the expected kernels fails at once, and
    one that shows them exactly ends the search.  Returns the profile and
    the number of windows taken."""
    for i in range(1, tries + 1):
        prof = _profile(dev, fn)
        got = {k: prof.get(k, 0) for k in want}
        assert all(got[k] <= want[k] for k in want), \
            ("more device kernels than expected", want, prof)
        if got == want and "kernels" in prof:
            return prof, i
    raise AssertionError(("no complete profiler window", want, tries, prof))


def profile_path(dev, clock, g, ge):
    """Device kernels and device-busy time per factorization and per solve,
    for the replays (``g``) and the steps one by one (``ge``), and this
    host's cost of one small PyTorch op on the card (the unit the eager
    steps pay per launch).  Busy share = device-busy time over the
    CUDA-event time of the same call.  The eager factorization must show
    exactly one run-kernel device kernel per run and one dense-LU device
    kernel per dense group; a replay's window is recorded as it comes (the
    profiler's view of kernels inside a graph is reported, not assumed)."""
    b = torch.ones(g.n, dtype=g.dtype, device=dev)
    y = torch.zeros(8, dtype=g.dtype, device=dev)
    out = {"host_op_us": clock.ms(lambda: [y.add_(1.0) for _ in range(1000)],
                                  reps=3)}
    steps = g._factorizer.step_kinds
    n_dense, n_runs = steps.count("dense"), steps.count("run")
    none = {"dense_lu_kernels": 0, "level_run_kernels": 0}
    for name, fn, want in (
            ("eager_factorize", ge._factorizer.run,
             {"dense_lu_kernels": n_dense, "level_run_kernels": n_runs}),
            ("eager_solve", lambda: ge._solver.solve(ge._vals, b), none),
            ("factorize", g._factorizer.run, None),
            ("solve", lambda: g._solver.solve(g._vals, b), None)):
        if want is None:
            prof, prof["profiler_tries"] = _profile(dev, fn), 1
        else:
            prof, prof["profiler_tries"] = _profile_until(dev, fn, want)
        if "device_busy_ms" in prof:
            prof["event_ms"] = clock.ms(fn, reps=5)
            prof["device_busy_share"] = prof["device_busy_ms"] / prof["event_ms"]
        out[name] = prof
    fact, eager = out["factorize"], out["eager_factorize"]
    log(f"profile: steps one by one: {eager['level_run_kernels']} run-kernel "
        f"device kernel(s) for {n_runs} run(s) and "
        f"{eager['dense_lu_kernels']} dense-LU device kernel(s) for {n_dense} "
        f"dense group(s) per factorization ok; {eager['kernels']} device "
        f"kernels a factorization, {out['eager_solve'].get('kernels')} a "
        f"solve; one replay: {fact.get('kernels')} device kernels a "
        f"factorization ({fact.get('level_run_kernels')} run, "
        f"{fact.get('dense_lu_kernels')} dense-LU), "
        f"{out['solve'].get('kernels')} a solve; busy share factorize "
        f"{fact.get('device_busy_share')}, solve "
        f"{out['solve'].get('device_busy_share')}")
    return out


def robust_k1_entry(dev, clock, rec_k1, report, crush: bool = False):
    """K1's robust instantiation on a path's recorded run (its tau; a
    batch's (B, n) values with (B,) tau and counts when the path was
    batched; real or complex values): kernel against plain version bit for
    bit and bump for bump, times of kernel, plain version and the library
    route (per level, ``perturb_diags`` and the per-level eager steps with
    one ``scatter_add_``).  ``crush``: first crush the recorded values'
    diagonals below tau (:func:`crush_diagonals`), so that every level
    bumps."""
    from repro_torch.kernels import level_run
    from repro_torch.kernels.ref import level_run_ref

    (v0, run, (tau, _)), = rec_k1
    batched = v0.dim() == 2
    cplx = v0.is_complex()
    planes = 2 if cplx else 1
    if crush:
        rng = np.random.default_rng(SEED + 5)
        v0 = v0.clone()
        for row, t in zip(v0.view(-1, v0.shape[-1]), tau.view(-1).tolist()):
            crush_diagonals(rng, run, row, below=t)
    count = torch.zeros(v0.shape[:-1], dtype=torch.int32, device=dev)
    got, want = v0.clone(), v0.clone()
    c_got, c_want = count.clone(), count.clone()
    level_run(got, run, tau, c_got)
    level_run_ref(want, run, tau, c_want)
    torch.cuda.synchronize(dev)
    bumps = c_got.tolist()
    assert torch.equal(got, want) and bumps == c_want.tolist(), \
        ("robust K1 differs from its plain version on the path's run",
         (got - want).abs().max().item(), bumps, c_want.tolist())
    buf = v0.clone()
    copy_ms = clock.ms(lambda: buf.copy_(v0), reps=20)
    levels = run.ref_levels()
    lib_idx = _library_index(levels, v0)

    def timed(fn, reps):
        def call():
            buf.copy_(v0)
            count.zero_()
            fn(buf, count)
        return max(clock.ms(call, reps=reps) - copy_ms, 0.0)

    n_bytes, n_ops = _k1_bound(run, v0.element_size() // planes, planes,
                               int(c_got.sum()),
                               batch=v0.numel() // v0.shape[-1])
    ent = dict(name="level_run_robust" + ("_batched" if batched else ""),
               route="cuda", source="src/repro_torch/kernels/csrc/level_run.cu",
               replaces=K1_SITES[(cplx, batched)][1],
               launches=report["k1_launches"], max_abs_err=0.0,
               ms=timed(lambda v, c: level_run(v, run, tau, c), 20),
               plain_ms=timed(lambda v, c: level_run_ref(v, run, tau, c), 3),
               **_bound(n_bytes, n_ops),
               library_ms=timed(lambda v, c: _library_level_route(
                   v, levels, lib_idx, tau, c), 10))
    ent.update(matrix=report["matrix"], dtype=str(v0.dtype), levels=run.n_levels,
               updates=run.n_updates, bumps=bumps, crushed=crush,
               bytes=n_bytes, operations=n_ops, copy_ms=copy_ms,
               ratio_to_library=ent["ms"] / ent["library_ms"],
               library="per level perturb_diags + the eager steps, one "
                       "scatter_add_ a level",
               also_replaces=("src/repro/kernels/ops.py:244 "
                              "(_perturb_diags_planar_body, per level)" if cplx
                              else "src/repro/kernels/ops.py:220 "
                                   "(_perturb_diags_body, per level)"))
    if batched:
        ent.update(batch=v0.shape[0],
                   kernel_site="src/repro/kernels/level_update.py:60")
    log(f"{report['matrix']}: {ent['name']} {v0.dtype} ({run.n_levels} levels"
        f"{', diagonals crushed below tau' if crush else ''}, {bumps} bumps"
        f"{'' if batched else f' at tau={tau.item():.3e}'}) {ent['ms']:.4f} "
        f"ms, bit-identical to the plain version ({ent['plain_ms']:.3f} ms), "
        f"bump for bump; library route {ent['library_ms']:.4f} ms; bound "
        f"{ent['bound_ms']:.5f} ms ({ent['bound_by']})")
    return ent


def drive_static_pivot(dev, clock):
    """Phase 7: ``GLU(grid64, static_pivot=...)``, replays against the steps
    one by one, and the robust K1 on the path's recorded run."""
    from repro_torch import GLU

    A = make_matrix("grid64")
    rng = np.random.default_rng(SEED + 1)
    b = rng.normal(size=A.n)
    reset_counts()
    g = GLU(A, static_pivot=PIVOT_EPS)
    x = g.factorize().solve(b)
    torch.cuda.synchronize(dev)
    k1, k2, _ = launch_counts()
    runs = g._factorizer.step_kinds.count("run")
    assert k1 == runs == 1 and k2 == 1, (k1, k2)
    assert g.residual(b, x) < 1e-9
    log(f"static pivot: grid64 path K1 launches={k1} (robust instantiation), "
        f"K2 launches={k2}, n_perturbed={g.solve_info['n_perturbed']}")
    report = {"matrix": "grid64", "k1_launches": k1, "static_pivot": {}}
    S = A.to_scipy()
    for eps in (PIVOT_EPS, PIVOT_EPS_BUMPS):
        g = GLU(A, static_pivot=eps)
        ge = GLU(A, static_pivot=eps, jit_schedule=False)
        counts = []
        for i, new in enumerate([np.asarray(A.data)]
                                + [newton_values(A, rng) for _ in range(3)]):
            x, xe = g.factorize(new).solve(b), ge.factorize(new).solve(b)
            info, einfo = g.solve_info, ge.solve_info
            assert torch.equal(g.factorized_values(), ge.factorized_values())
            assert x.tobytes() == xe.tobytes(), (eps, i)
            assert info["n_perturbed"] == einfo["n_perturbed"], (eps, i)
            if i:
                assert info["n_dispatches"] == info["solve_dispatches"] == 1
            S.data = new
            res = float(np.abs(S @ x - b).max() / np.abs(b).max())
            if eps == PIVOT_EPS:
                assert res < 1e-9 and info["n_perturbed"] == 0, (res, info)
            else:
                assert info["n_perturbed"] > 0 and np.isfinite(x).all()
            counts.append(info["n_perturbed"])
        report["static_pivot"][str(eps)] = dict(n_perturbed=counts)
        log(f"static pivot eps={eps:g}: 4 factorizations and solves, one "
            f"replay each, bit-identical to the steps one by one, bumps "
            f"{counts} (equal)")
        if eps == PIVOT_EPS:
            rec = record_kernel_inputs(ge, np.asarray(A.data))
            t_fact = clock.ms(g._factorizer.run, reps=20)
            t_eager = clock.ms(ge._factorizer.run, reps=10)
            report.update(factorize_ms=t_fact, eager_factorize_ms=t_eager)
            log(f"static pivot eps={eps:g}: grid64 factorize {t_fact:.4f} ms "
                f"one replay, {t_eager:.4f} ms steps one by one")
    return report, robust_k1_entry(dev, clock, rec["k1"], report)


def drive_complex_static_pivot(dev, clock):
    """Phase 7, complex values: ``GLU(rajat12_ac, dtype=complex128,
    static_pivot=...)`` driven with the counters at 0 (the complex robust K1
    inside the graph, the tail guarded before K3), replays against the
    steps one by one bit for bit and bump for bump over other frequencies,
    and the complex robust K1 on the path's recorded run with its
    diagonals crushed below tau."""
    from repro_torch import GLU

    A = make_matrix("rajat12_ac")
    rng = np.random.default_rng(SEED + 6)
    b = rng.normal(size=A.n) + 1j * rng.normal(size=A.n)
    reset_counts()
    g = GLU(A, dtype=torch.complex128, static_pivot=PIVOT_EPS)
    x = g.factorize().solve(b)
    torch.cuda.synchronize(dev)
    k1, k2, k3 = launch_counts()
    steps = g._factorizer.step_kinds
    assert k1 == steps.count("run") == 1 and (k2, k3) == (0, 1), (k1, k2, k3)
    assert g.residual(b, x) < 1e-9
    log(f"complex static pivot: rajat12_ac path K1 launches={k1} (complex "
        f"robust instantiation), K3 launches={k3}, n_perturbed="
        f"{g.solve_info['n_perturbed']}")
    report = {"matrix": "rajat12_ac", "k1_launches": k1, "static_pivot": {}}
    S = A.to_scipy()
    sets = [np.asarray(A.data)] + refactor_values("rajat12_ac", A, rng)[:3]
    rec = None
    for eps in (PIVOT_EPS, PIVOT_EPS_BUMPS_AC):
        g = GLU(A, dtype=torch.complex128, static_pivot=eps)
        ge = GLU(A, dtype=torch.complex128, static_pivot=eps,
                 jit_schedule=False)
        counts = []
        for i, new in enumerate(sets):
            x, xe = g.factorize(new).solve(b), ge.factorize(new).solve(b)
            info = g.solve_info
            assert torch.equal(g.factorized_values(), ge.factorized_values())
            assert x.tobytes() == xe.tobytes(), (eps, i)
            assert info["n_perturbed"] == ge.solve_info["n_perturbed"], (eps, i)
            if i:
                assert info["n_dispatches"] == info["solve_dispatches"] == 1
            S.data = new
            res = float(np.abs(S @ x - b).max() / np.abs(b).max())
            if eps == PIVOT_EPS:
                assert res < 1e-9 and info["n_perturbed"] == 0, (res, info)
            else:
                assert info["n_perturbed"] > 0 and np.isfinite(x).all()
            counts.append(info["n_perturbed"])
        report["static_pivot"][str(eps)] = dict(n_perturbed=counts)
        log(f"complex static pivot eps={eps:g}: 4 factorizations and solves "
            f"(other frequencies), one replay each, bit-identical to the "
            f"steps one by one, bumps {counts} (equal)")
        if eps == PIVOT_EPS:
            rec = record_kernel_inputs(ge, np.asarray(A.data))
            report.update(factorize_ms=clock.ms(g._factorizer.run, reps=20),
                          eager_factorize_ms=clock.ms(ge._factorizer.run,
                                                      reps=10))
            log(f"complex static pivot eps={eps:g}: rajat12_ac factorize "
                f"{report['factorize_ms']:.4f} ms one replay, "
                f"{report['eager_factorize_ms']:.4f} ms steps one by one")
    return report, robust_k1_entry(dev, clock, rec["k1"], report, crush=True)


def newton_breakdown(dev, ckt, g, volts, dt):
    """Per Newton iterate, the parts of ``GLU.factorize`` + ``GLU.solve``
    as the transient loop calls them (refine=1), each timed alone: numpy
    assembly, host preparation (scaling and permutation of values and
    right-hand side), host-to-device copies, the factorization replay
    (CUDA events), the |A| pass and the solve's replays with their one
    device-to-host read of the stopping test (CUDA events), and the
    solution's device-to-host copy.  Iterates: the run's own time points,
    at their converged voltages."""
    fz, sv = g._factorizer, g._solver
    rows = []
    for s in range(1, len(volts)):
        t0 = time.perf_counter()
        vals, rhs = ckt.assemble(volts[s], volts[s - 1], dt, s * dt)
        t1 = time.perf_counter()
        data = (vals * g._scale_data)[g._data_perm]
        bp = (rhs * g.Dr)[g._inv_row]
        t2 = time.perf_counter()
        fz.load(data)
        b_dev = torch.from_numpy(bp).to(dev)
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        vals_dev = fz.run()
        ev[1].record()
        ev[2].record()
        torch.abs(g._a_vals, out=g._a_abs)
        x, _ = sv.solve_refined(vals_dev, b_dev, g._spmv_rows, g._spmv_cols,
                                g._a_vals, g._a_abs, max_iter=1,
                                tol=g.refine_tol)
        ev[3].record()
        torch.cuda.synchronize(dev)
        t4 = time.perf_counter()
        xh = x.cpu().numpy()[g.col_map] * g.Dc
        t5 = time.perf_counter()
        assert np.isfinite(xh).all()
        rows.append(dict(assembly_ms=(t1 - t0) * 1e3,
                         host_prep_ms=(t2 - t1) * 1e3,
                         h2d_ms=(t3 - t2) * 1e3,
                         factorize_replay_ms=ev[0].elapsed_time(ev[1]),
                         solve_replays_ms=ev[2].elapsed_time(ev[3]),
                         solve_host_ms=(t4 - t3) * 1e3,
                         d2h_ms=(t5 - t4) * 1e3))
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def drive_transient(dev):
    """Phase 8: the Newton transient on the card at grid64's width."""
    from repro_torch import GLU
    from repro_torch.circuit import rc_grid_circuit, transient
    from repro_torch.sparse import CSC

    c = TRANSIENT
    ckt = rc_grid_circuit(c["nx"], c["ny"], with_diodes=True, seed=0)
    kw = dict(t_end=c["t_end"], dt=c["dt"], refine=c["refine"])
    reset_counts()
    t0 = time.perf_counter()
    res = transient(ckt, **kw)
    wall_s = time.perf_counter() - t0
    k1, k2, _ = launch_counts()
    eager = transient(ckt, jit_schedule=False, **kw)
    n_fact = res.n_factorizations
    log(f"transient: n={ckt.n}, {len(res.times)} time steps, Newton iterates "
        f"{res.newton_iters.tolist()}, {n_fact} factorizations, K1 launches "
        f"{k1}, K2 launches {k2}, max_residual {res.max_residual:.3e}, "
        f"ladder {res.ladder_counts}; setup {res.setup_seconds:.3f} s, loop "
        f"{res.solve_seconds:.3f} s ({res.solve_seconds / n_fact * 1e3:.3f} "
        f"ms an iterate; steps one by one: {eager.solve_seconds:.3f} s, "
        f"{eager.solve_seconds / eager.n_factorizations * 1e3:.3f} ms)")
    # the driver's GLU, built again with its options (a plan-cache hit):
    # its steps, and the breakdown below
    pat = ckt.pattern()
    v0 = np.zeros(ckt.n)
    g = GLU(CSC(pat.n, pat.indptr, pat.indices,
                ckt.assemble(v0, v0, c["dt"], 0.0)[0]), refine=c["refine"])
    steps = g._factorizer.step_kinds
    assert res.max_residual < 1e-8, res.max_residual
    assert np.isfinite(res.voltages).all()
    assert res.voltages.shape == (len(res.times), ckt.n)
    assert n_fact == res.newton_iters.sum()
    assert steps.count("run") >= 1 and k1 == steps.count("run") * n_fact \
        and k2 == steps.count("dense") * n_fact, (k1, k2, n_fact, steps)
    assert res.ladder_counts == dict(refactorize=n_fact, rescale=0, bump=0,
                                     replan=0), res.ladder_counts
    assert res.voltages.tobytes() == eager.voltages.tobytes()
    assert eager.n_factorizations == n_fact
    log(f"transient: steps {steps}; voltages bit-identical to the run with "
        "the steps one by one ok")
    g.factorize()
    g.solve(np.ones(ckt.n))            # captures the refined solve's graphs
    volts = np.concatenate([v0[None], res.voltages])
    breakdown = newton_breakdown(dev, ckt, g, volts, c["dt"])
    log("transient: per Newton iterate (medians over the run's time points): "
        + ", ".join(f"{k} {v:.4f}" for k, v in breakdown.items()))
    # the same run on the warmed GLU: the loop without the first calls'
    # eager steps and captures
    steady = transient(ckt, glu=g, **kw)
    assert steady.voltages.tobytes() == res.voltages.tobytes()
    steady_ms = steady.solve_seconds / steady.n_factorizations * 1e3
    log(f"transient: on a GLU whose graphs are captured: loop "
        f"{steady.solve_seconds:.3f} s, {steady_ms:.3f} ms an iterate, "
        "voltages bit-identical")
    return dict(n=ckt.n, steps=len(res.times),
                newton_iters=res.newton_iters.tolist(),
                n_factorizations=n_fact, k1_launches=k1, k2_launches=k2,
                max_residual=res.max_residual, setup_s=res.setup_seconds,
                loop_s=res.solve_seconds, wall_s=wall_s,
                iterate_ms=res.solve_seconds / n_fact * 1e3,
                eager_loop_s=eager.solve_seconds,
                eager_iterate_ms=eager.solve_seconds
                / eager.n_factorizations * 1e3,
                steady_loop_s=steady.solve_seconds, steady_iterate_ms=steady_ms,
                breakdown=breakdown)


def batch_values(name, A, B, rng):
    """B value vectors on A's pattern: for the real matrices the entries
    times 1 + 0.1 U(-1, 1) (as ``benchmarks/bench_batched.py`` perturbs
    them), for rajat12_ac B frequencies over ``BATCH_AC_OMEGAS``."""
    from repro_torch.sparse import ac_jacobian

    if name == "rajat12_ac":
        return np.stack([ac_jacobian(1879, omega=w, avg_degree=6.9,
                                     seed=0).data
                         for w in np.logspace(*BATCH_AC_OMEGAS, B)])
    return np.asarray(A.data)[None] * (
        1.0 + 0.1 * rng.uniform(-1.0, 1.0, size=(B, A.nnz)))


def _residuals(A, batch, x, bs):
    """Each matrix's ``||A_b x_b - b_b|| / ||b_b||`` (inf norms)."""
    S = A.to_scipy()
    out = []
    for vals, xb, bb in zip(batch, x, bs):
        S.data = vals
        out.append(float(np.abs(S @ xb - bb).max() / np.abs(bb).max()))
    return out


def drive_batched(dev, clock, name, want_k1, want_k2, want_k3):
    """Phases 9-10 for one matrix: the batched engine at each batch size of
    ``BATCHES``, the counters at 0 just before the first batched
    factorization and solve and read just after.  Returns the reports, the
    kernels' inputs recorded from a factorization at the largest batch, and
    that batch's report for the kernel entries."""
    from repro_torch import GLU

    A = make_matrix(name)
    cplx = np.iscomplexobj(A.data)
    dtype = torch.complex128 if cplx else torch.float64
    rng = np.random.default_rng(SEED + 2)
    g1 = GLU(A, dtype=dtype)            # one matrix at a time, the yardstick
    reports, rec, ent_report = [], None, None
    for B in BATCHES[name]:
        batch = batch_values(name, A, B, rng)
        bs = rng.normal(size=(B, A.n)) + (1j * rng.normal(size=(B, A.n))
                                          if cplx else 0.0)
        # -- the path: counters at 0 just before, read just after -----------
        reset_counts()
        t0 = time.perf_counter()
        g = GLU(A, dtype=dtype)
        g.factorize_batched(batch)
        x = g.solve_batched(bs)
        torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - t0
        k1, k2, k3 = launch_counts()
        fz = g._factorizer
        steps = fz.step_kinds
        runs = [gr.arrays[0] for gr in fz._groups if gr.kind == "run"]
        info = g.solve_info
        assert k1 == len(runs) == want_k1, (name, B, k1, want_k1)
        assert (k2, k3) == (want_k2, want_k3), (name, B, k2, k3)
        assert info["batched"] and info["kernels_disabled_reason"] is None
        # the batch's values keep the plan's MC64 scaling of A's own: an
        # unrefined solve's residual is the values' conditioning, and the
        # bar of 1e-9 holds each matrix's refined solve to it
        res0 = _residuals(A, batch, x, bs)
        res = _residuals(A, batch, g.solve_batched(bs, refine=2), bs)
        assert x.shape == (B, A.n) and np.isfinite(x).all() \
            and max(res) < 1e-9, (name, B, max(res))
        log(f"{name} batched B={B}: path K1 launches={k1}, K2={k2}, K3={k3} "
            f"(one batched launch each for the whole batch), residuals max "
            f"{max(res0):.3e} unrefined, {max(res):.3e} < 1e-9 with refine=2; "
            f"GLU build + first batched factorize and solve {first_s:.3f} s "
            f"(steps one by one, then the captures)")

        # -- refactorization: one replay each, against the steps one by one
        #    and against one matrix at a time ---------------------------------
        ge = GLU(A, dtype=dtype, jit_schedule=False)
        new = batch_values(name, A, B, rng) if name != "rajat12_ac" else \
            batch * (1.0 + 0.01 * rng.uniform(-1.0, 1.0, size=batch.shape))
        before = launch_counts()
        x = g.factorize_batched(new).solve_batched(bs)
        torch.cuda.synchronize(dev)
        after = launch_counts()
        disp = (g.solve_info["n_dispatches"], g.solve_info["solve_dispatches"])
        assert disp == (1, 1), (name, B, disp)
        assert tuple(a - b for a, b in zip(after, before)) == (k1, k2, k3)
        xe = ge.factorize_batched(new).solve_batched(bs)
        vals = g.factorized_values_batched()
        assert torch.equal(vals, ge.factorized_values_batched()), (name, B)
        assert x.tobytes() == xe.tobytes(), (name, B)
        for b in range(B):
            xs = g1.factorize(new[b]).solve(bs[b])
            assert torch.equal(g1.factorized_values(), vals[b]), (name, B, b)
            assert xs.tobytes() == x[b].tobytes(), (name, B, b)
        res0 = _residuals(A, new, x, bs)
        xr = g.solve_batched(bs, refine=2)
        rinfo = g.solve_info
        xre = ge.solve_batched(bs, refine=2)
        res = _residuals(A, new, xr, bs)
        assert max(res) < 1e-9, (name, B, max(res))
        assert rinfo["converged"].all() and xr.tobytes() == xre.tobytes()
        assert rinfo["refine_iters"].tolist() == \
            ge.solve_info["refine_iters"].tolist()
        log(f"{name} batched B={B}: refactorization one replay each for "
            f"factorize_batched and solve_batched, bit-identical to the steps "
            f"one by one ({ge.solve_info['n_dispatches']} steps) and to one "
            f"GLU a matrix (factors and solutions); refine=2 bit-identical, "
            f"iters {rinfo['refine_iters'].tolist()}; residuals max "
            f"{max(res0):.3e} unrefined, {max(res):.3e} < 1e-9 refined")

        # -- timings: values on the card ---------------------------------------
        bp = torch.as_tensor((bs * g.Dr[None, :])[:, g._inv_row], dtype=dtype,
                             device=dev)
        fact_ms = clock.ms(fz.run_batched, reps=20)
        fact_eager_ms = clock.ms(ge._factorizer.run_batched, reps=5)
        solve_ms = clock.ms(lambda: g._solver.solve_batched(g._vals_batch, bp),
                            reps=5)
        g1.factorize(new[0])
        one_fact_ms = clock.ms(lambda: [g1._factorizer.run()
                                        for _ in range(B)], reps=5)
        one_solve_ms = clock.ms(lambda: [g1._solver.solve(g1._vals, bp[0])
                                         for _ in range(B)], reps=2)
        prof = {"eager_factorize": _profile_until(
            dev, ge._factorizer.run_batched,
            {"level_run_kernels": len(runs),
             "dense_lu_kernels": steps.count("dense")})[0],
            "factorize": _profile(dev, fz.run_batched),
            "solve": _profile(dev, lambda: g._solver.solve_batched(
                g._vals_batch, bp))}
        for key, fn in (("factorize", fz.run_batched),
                        ("solve", lambda: g._solver.solve_batched(
                            g._vals_batch, bp))):
            if "device_busy_ms" in prof[key]:
                prof[key]["event_ms"] = clock.ms(fn, reps=5)
                prof[key]["device_busy_share"] = (prof[key]["device_busy_ms"]
                                                  / prof[key]["event_ms"])
        rep = dict(matrix=name, batch=B, dtype=str(dtype), k1_launches=k1,
                   k2_launches=k2, k3_launches=k3, first_call_s=first_s,
                   factorize_dispatches=1, solve_dispatches=1,
                   eager_factorize_steps=ge.solve_info["n_dispatches"],
                   residual_max=max(res), unrefined_residual_max=max(res0),
                   refine2_iters=rinfo["refine_iters"].tolist(),
                   factorize_ms=fact_ms, factorize_ms_per_matrix=fact_ms / B,
                   eager_factorize_ms=fact_eager_ms,
                   single_factorizes_ms=one_fact_ms,
                   solve_ms=solve_ms, solve_ms_per_matrix=solve_ms / B,
                   single_solves_ms=one_solve_ms, profile=prof)
        reports.append(rep)
        log(f"{name} batched B={B}: factorize_batched {fact_ms:.4f} ms one "
            f"replay ({fact_ms / B:.4f} ms a matrix; {B} single replays "
            f"{one_fact_ms:.4f} ms; steps one by one {fact_eager_ms:.4f} ms); "
            f"solve_batched {solve_ms:.4f} ms one replay ({solve_ms / B:.4f} "
            f"ms a matrix; {B} single replays {one_solve_ms:.4f} ms); device "
            f"kernels a factorization {prof['factorize'].get('kernels')} "
            f"(busy {prof['factorize'].get('device_busy_share')}), a solve "
            f"{prof['solve'].get('kernels')} (busy "
            f"{prof['solve'].get('device_busy_share')})")
        if B == max(BATCHES[name]):
            rec = record_kernel_inputs(ge, new, batched=True)
            ent_report = dict(
                matrix=name, planes=2 if cplx else 1,
                k1_levels=fz.kinds.count("pallas"), k1_launches=k1,
                k2_launches=k2, k3_launches=k3,
                k1_updates=sum(r.n_updates for r in runs),
                k1_rows=sum(len(r.host["rows"]) for r in runs),
                tail_sizes=([fz.dense_tail_info["size"]]
                            if fz.dense_tail_info else []),
                eager_profile=prof["eager_factorize"])
        del g, ge
    return reports, rec, ent_report


def drive_batched_static_pivot(dev, clock):
    """Phase 11: ``GLU(grid64, static_pivot=...)`` on a batch of
    ``PIVOT_BATCH`` matrices: the batched robust K1 inside the replay,
    per-matrix bump counts equal between the replay, the steps one by one,
    one GLU a matrix and (at the path's recorded run) K1's batched plain
    version."""
    from repro_torch import GLU

    A = make_matrix("grid64")
    rng = np.random.default_rng(SEED + 3)
    B = PIVOT_BATCH
    bs = rng.normal(size=(B, A.n))
    sets = [batch_values("grid64", A, B, rng)] + [
        np.stack([newton_values(A, rng) for _ in range(B)]) for _ in range(2)]
    reset_counts()
    g = GLU(A, static_pivot=PIVOT_EPS)
    x = g.factorize_batched(sets[0]).solve_batched(bs)
    torch.cuda.synchronize(dev)
    k1, k2, _ = launch_counts()
    assert k1 == g._factorizer.step_kinds.count("run") == 1 and k2 == 1
    assert np.isfinite(x).all() and max(_residuals(
        A, sets[0], g.solve_batched(bs, refine=2), bs)) < 1e-9
    report = {"matrix": "grid64", "batch": B, "k1_launches": k1,
              "static_pivot": {}}
    log(f"batched static pivot: grid64 B={B} path K1 launches={k1} (robust "
        f"batched instantiation), K2 launches={k2}, n_perturbed="
        f"{g.solve_info['n_perturbed'].tolist()}")
    rec = None
    for eps in (PIVOT_EPS, PIVOT_EPS_BUMPS):
        g = GLU(A, static_pivot=eps)
        ge = GLU(A, static_pivot=eps, jit_schedule=False)
        g1 = GLU(A, static_pivot=eps)
        counts = []
        for i, vals in enumerate(sets):
            x = g.factorize_batched(vals).solve_batched(bs)
            xe = ge.factorize_batched(vals).solve_batched(bs)
            info = g.solve_info
            n = info["n_perturbed"].tolist()
            assert n == ge.solve_info["n_perturbed"].tolist(), (eps, i)
            f = g.factorized_values_batched()
            assert torch.equal(f, ge.factorized_values_batched())
            assert x.tobytes() == xe.tobytes(), (eps, i)
            if i:
                assert (info["n_dispatches"], info["solve_dispatches"]) == (1, 1)
            for b in range(B):
                g1.factorize(vals[b])
                assert g1.solve_info["n_perturbed"] == n[b], (eps, i, b)
                assert torch.equal(g1.factorized_values(), f[b]), (eps, i, b)
            if eps == PIVOT_EPS:
                assert not any(n) and max(_residuals(
                    A, vals, g.solve_batched(bs, refine=2), bs)) < 1e-9
            else:
                assert sum(n) > 0 and np.isfinite(x).all(), n
            counts.append(n)
        report["static_pivot"][str(eps)] = dict(n_perturbed=counts)
        log(f"batched static pivot eps={eps:g}: 3 batched factorizations and "
            f"solves, one replay each, bit-identical to the steps one by one "
            f"and to one GLU a matrix, bumps a matrix {counts} (equal)")
        if eps == PIVOT_EPS_BUMPS:
            rec = record_kernel_inputs(ge, sets[0], batched=True)
            report.update(factorize_ms=clock.ms(g._factorizer.run_batched,
                                                reps=20),
                          eager_factorize_ms=clock.ms(
                              ge._factorizer.run_batched, reps=5))
    return report, robust_k1_entry(dev, clock, rec["k1"], report)


def sweep_breakdown(dev, ckts, g, volts, dt):
    """Per Newton iterate of the sweep, its parts as ``refactorize_solve``
    runs them (refine=1), each timed alone: numpy assembly of the B
    circuits, host preparation, host-to-device copies, the batched
    factorization replay (CUDA events), the |A| pass and the batched
    refined solve's replays with their device-to-host read (CUDA events),
    and the solutions' device-to-host copy.  Iterates: the run's own time
    points, at their converged voltages."""
    fz, sv = g._factorizer, g._solver
    B, n = len(ckts), volts.shape[-1]
    rows = []
    for s in range(1, volts.shape[1]):
        t0 = time.perf_counter()
        vals = np.empty((B, ckts[0].pattern().nnz))
        rhs = np.empty((B, n))
        for k, c in enumerate(ckts):
            vals[k], rhs[k] = c.assemble(volts[k, s], volts[k, s - 1], dt,
                                         s * dt)
        t1 = time.perf_counter()
        data = g._scaled(vals)
        bp = (rhs * g.Dr[None, :])[:, g._inv_row]
        t2 = time.perf_counter()
        fz.load_batched(data)
        b_dev = torch.from_numpy(bp).to(dev)
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        vals_dev = fz.run_batched()
        ev[1].record()
        ev[2].record()
        torch.abs(g._a_vals_batch, out=g._a_abs_batch)
        x, _ = sv.solve_refined_batched(vals_dev, b_dev, g._spmv_rows,
                                        g._spmv_cols, g._a_vals_batch,
                                        g._a_abs_batch, max_iter=1,
                                        tol=g.refine_tol)
        ev[3].record()
        torch.cuda.synchronize(dev)
        t4 = time.perf_counter()
        xh = x.cpu().numpy()[:, g.col_map] * g.Dc[None, :]
        t5 = time.perf_counter()
        assert np.isfinite(xh).all()
        rows.append(dict(assembly_ms=(t1 - t0) * 1e3,
                         host_prep_ms=(t2 - t1) * 1e3,
                         h2d_ms=(t3 - t2) * 1e3,
                         factorize_replay_ms=ev[0].elapsed_time(ev[1]),
                         solve_replays_ms=ev[2].elapsed_time(ev[3]),
                         solve_host_ms=(t4 - t3) * 1e3,
                         d2h_ms=(t5 - t4) * 1e3))
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def drive_sweep(dev):
    """Phase 12: the lockstep transient sweep of ``SWEEP["scales"]``
    copies of the 64 x 64 grid, each copy held against ``transient`` of
    its own circuit."""
    from repro_torch import GLU
    from repro_torch.circuit import (
        perturbed_copies,
        rc_grid_circuit,
        transient,
        transient_sweep,
    )
    from repro_torch.sparse import CSC

    c = SWEEP
    ckt = rc_grid_circuit(c["nx"], c["ny"], with_diodes=True, seed=0)
    kw = dict(t_end=c["t_end"], dt=c["dt"], refine=c["refine"])
    scales = np.asarray(c["scales"])
    B = len(scales)
    reset_counts()
    t0 = time.perf_counter()
    res = transient_sweep(ckt, scales=scales, **kw)
    wall_s = time.perf_counter() - t0
    k1, k2, _ = launch_counts()
    n_fact = res.n_batched_factorizations
    ckts = perturbed_copies(ckt, scales)
    pat = ckt.pattern()
    v0 = np.zeros(ckt.n)
    g = GLU(CSC(pat.n, pat.indptr, pat.indices,
                ckts[0].assemble(v0, v0, c["dt"], 0.0)[0]), refine=c["refine"])
    steps = g._factorizer.step_kinds
    log(f"transient sweep: n={ckt.n}, B={B} copies (scales "
        f"{np.round(scales, 4).tolist()}), {len(res.times)} time steps, Newton "
        f"iterates {res.newton_iters.tolist()}, {n_fact} batched "
        f"factorizations, K1 launches {k1}, K2 launches {k2}, max_residual "
        f"{res.max_residual:.3e}, ladder {res.ladder_counts}; setup "
        f"{res.setup_seconds:.3f} s, loop {res.solve_seconds:.3f} s "
        f"({res.solve_seconds / n_fact * 1e3:.3f} ms an iterate, "
        f"{res.solve_seconds / n_fact / B * 1e3:.3f} ms a copy and iterate)")
    assert res.max_residual < 1e-8, res.max_residual
    assert np.isfinite(res.voltages).all()
    assert res.voltages.shape == (B, len(res.times), ckt.n)
    assert n_fact == res.newton_iters.sum()
    assert k1 == steps.count("run") * n_fact and \
        k2 == steps.count("dense") * n_fact, (k1, k2, n_fact, steps)
    assert res.ladder_counts == dict(refactorize=n_fact, rescale=0, bump=0,
                                     replan=0), res.ladder_counts
    # each copy alone through the single-matrix transient
    diffs, single_s = [], 0.0
    for k, ck in enumerate(ckts):
        one = transient(ck, **kw)
        single_s += one.solve_seconds
        diffs.append(float(np.abs(res.voltages[k] - one.voltages).max()))
    assert max(diffs) < 1e-9, diffs
    log(f"transient sweep: every copy within {max(diffs):.3e} (< 1e-9) of "
        f"transient on its own circuit; the {B} single runs' loops "
        f"{single_s:.3f} s together against the sweep's {res.solve_seconds:.3f}"
        " s")
    g.factorize_batched(np.stack([ck.assemble(v0, v0, c["dt"], 0.0)[0]
                                  for ck in ckts]))
    g.solve_batched(np.ones((B, ckt.n)))     # captures the refined graphs
    volts = np.concatenate([np.zeros((B, 1, ckt.n)), res.voltages], axis=1)
    breakdown = sweep_breakdown(dev, ckts, g, volts, c["dt"])
    log("transient sweep: per Newton iterate of the batch (medians over the "
        "run's time points): "
        + ", ".join(f"{k} {v:.4f}" for k, v in breakdown.items()))
    return dict(n=ckt.n, batch=B, scales=scales.tolist(),
                steps=len(res.times), newton_iters=res.newton_iters.tolist(),
                n_batched_factorizations=n_fact, k1_launches=k1,
                k2_launches=k2, max_residual=res.max_residual,
                max_diff_to_single=max(diffs), setup_s=res.setup_seconds,
                loop_s=res.solve_seconds, wall_s=wall_s,
                iterate_ms=res.solve_seconds / n_fact * 1e3,
                single_loops_s=single_s, breakdown=breakdown)


def drive_patterns(dev, clock, card, name):
    """Phase 13 for one matrix: solves pruned to a right-hand side's reach
    (``rhs_pattern``) and many right-hand sides (``solve_multi``), each a
    replay, held bit for bit against the full replays, the steps one by
    one and single solves."""
    from repro_torch import GLU

    A = make_matrix(name)
    n = A.n
    cplx = np.iscomplexobj(A.data)
    dtype = torch.complex128 if cplx else torch.float64
    rng = np.random.default_rng(SEED + 4)

    def draw(*shape):
        return rng.normal(size=shape) + (1j * rng.normal(size=shape)
                                         if cplx else 0.0)

    reset_counts()
    g = GLU(A, dtype=dtype)
    g.factorize()
    ge = GLU(A, dtype=dtype, jit_schedule=False)
    ge.factorize()
    torch.cuda.synchronize(dev)
    k1, k2, k3 = launch_counts()
    steps = g._factorizer.step_kinds
    assert k1 == 2 * steps.count("run") >= 2 and \
        k2 + k3 == 2 * steps.count("dense"), (name, k1, k2, k3)
    sv, vals = g._solver, g._vals

    def device_rhs(b):
        return torch.as_tensor((b * g.Dr)[..., g._inv_row], dtype=dtype,
                               device=dev)

    bp_full = device_rhs(draw(n))
    full_ms = clock.ms(lambda: sv.solve(vals, bp_full), reps=10)
    full_prof = _profile(dev, lambda: sv.solve(vals, bp_full))
    rows = []
    for label, pat in (("one node", [n // 2]),
                       ("three nodes", [1, n // 3, 2 * n // 3]),
                       ("every node", list(range(n)))):
        b = np.zeros(n, dtype=np.complex128 if cplx else np.float64)
        b[pat] = draw(len(pat))
        g.solve(b)
        x_full = g.solve(b)                                 # a replay
        x_first = g.solve(b, rhs_pattern=pat)               # warm-up, capture
        x = g.solve(b, rhs_pattern=pat)                     # a replay
        assert g.solve_info["solve_dispatches"] == 1
        xe = ge.solve(b, rhs_pattern=pat)
        eager_steps = ge.solve_info["solve_dispatches"]
        assert np.array_equal(x, x_full), (name, label)
        assert x.tobytes() == x_first.tobytes() == xe.tobytes(), (name, label)
        pp = g.row_map[np.unique(pat)]
        fwd, bwd, fr, br = sv.schedule_for_pattern(pp)
        bp = device_rhs(b)
        xp = sv.solve(vals, bp, rhs_pattern=pp).cpu().numpy()
        assert (xp[np.setdiff1d(np.arange(n), br)] == 0).all(), (name, label)
        ms = clock.ms(lambda: sv.solve(vals, bp, rhs_pattern=pp), reps=10)
        prof = _profile(dev, lambda: sv.solve(vals, bp, rhs_pattern=pp))
        row = dict(pattern=label, nodes=len(pat), fwd_reach=len(fr),
                   bwd_reach=len(br), fwd_levels=len(fwd), bwd_levels=len(bwd),
                   full_levels=[len(sv.fwd_levels), len(sv.bwd_levels)],
                   eager_steps=eager_steps, kernels=prof.get("kernels"),
                   full_kernels=full_prof.get("kernels"), solve_ms=ms,
                   full_solve_ms=full_ms)
        rows.append(row)
        log(f"{name} rhs_pattern {label}: reach {len(fr)} forward / {len(br)} "
            f"backward columns of {n}, levels kept {len(fwd)} / {len(bwd)} of "
            f"{len(sv.fwd_levels)} / {len(sv.bwd_levels)}, device kernels a "
            f"solve {row['kernels']} (full {row['full_kernels']}); replay "
            f"{ms:.4f} ms against the full replay {full_ms:.4f} ms; "
            "bit-identical to the full replay, to its warm-up and to the "
            "pruned steps one by one, exact zeros off the reach ok")

    B = draw(MULTI_K, n)
    g.solve_multi(B)
    X = g.solve_multi(B)
    assert g.solve_info["solve_dispatches"] == 1
    for k in range(MULTI_K):
        assert X[k].tobytes() == g.solve(B[k]).tobytes(), (name, k)
    Bp = device_rhs(B)
    multi_ms = clock.ms(lambda: sv.solve_multi(vals, Bp), reps=5)
    singles_ms = clock.ms(lambda: [sv.solve(vals, Bp[k])
                                   for k in range(MULTI_K)], reps=2)
    log(f"{name} solve_multi K={MULTI_K}: one replay, each row bit-identical "
        f"to a single solve; {multi_ms:.4f} ms against {MULTI_K} single "
        f"replays {singles_ms:.4f} ms")

    batch = batch_values(name, A, PATTERN_BATCH, rng)
    pat = [1, n // 3]
    bs = np.zeros((PATTERN_BATCH, n), dtype=B.dtype)
    bs[:, pat] = draw(PATTERN_BATCH, len(pat))
    g.factorize_batched(batch)
    full = g.solve_batched(bs)
    for _ in range(2):
        pruned = g.solve_batched(bs, rhs_pattern=pat)
    assert g.solve_info["solve_dispatches"] == 1
    assert np.array_equal(full, pruned), name
    log(f"{name} solve_batched B={PATTERN_BATCH} rhs_pattern {pat}: one "
        "replay, every row bit-identical to the unpruned batched solve")
    return dict(matrix=name, card=card, k1_launches=k1, k2_launches=k2,
                k3_launches=k3, patterns=rows, multi_k=MULTI_K,
                multi_ms=multi_ms, single_replays_ms=singles_ms,
                batch=PATTERN_BATCH)


def _ac_point_checks(ckt, res):
    """Per frequency point of an ``ac_sweep`` result: the relative error
    against scipy's ``splu`` on the host, the componentwise backward error
    on the original system, and whether every voltage stayed a normal
    float64 (far from the source a high-frequency response decays below
    2.2e-308, and those rows' backward error is about 1 in any package:
    the residual of a flushed entry against denominators that underflow)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    pat = ckt.pattern()
    vals, rhs = ckt.assemble_ac(res.op_point, res.freqs)
    err, berr, normal = [], [], []
    for v, b, x in zip(vals, rhs, res.voltages):
        A = sp.csc_matrix((v, pat.indices, pat.indptr), shape=(pat.n, pat.n))
        xr = spla.splu(A).solve(b)
        err.append(float(np.abs(x - xr).max() / np.abs(xr).max()))
        r = np.abs(A @ x - b)
        den = abs(A) @ np.abs(x) + np.abs(b)
        berr.append(float(np.where(den > 0, r / np.where(den > 0, den, 1.0),
                                   np.where(r > 0, np.inf, 0.0)).max()))
        normal.append(bool((np.abs(x) >= np.finfo(np.float64).tiny).all()))
    return np.array(err), np.array(berr), np.array(normal)


def drive_ac_sweep(dev, clock, card):
    """Phase 14: ``ac_sweep`` of the 64 x 64 grid at SPICE's ``.ac dec 10 1
    1meg``, with the counters at 0: as a user calls it (the escalation
    ladder on), then with ``escalation="none"`` (one batched factorization);
    each against the steps one by one bit for bit and against scipy per
    point; the time against F single ``GLU`` solves; then with
    ``static_pivot``: the complex robust batched K1 inside the graph, bump
    counts against the steps one by one, and the kernel on the path's
    recorded run."""
    from repro_torch import GLU
    from repro_torch.circuit import ac_sweep, rc_grid_circuit
    from repro_torch.sparse import CSC

    c = AC_SWEEP
    ckt = rc_grid_circuit(c["nx"], c["ny"], with_diodes=True, seed=0)
    ckt.add_ac_current_source(c["node"], 0, 1.0)
    freqs = np.logspace(*c["decades"], c["points"])
    F, n = len(freqs), ckt.n
    nodes = [c["node"] - 1]
    kw = dict(refine=c["refine"])
    report = dict(matrix=f"rc_grid_circuit({c['nx']}, {c['ny']}) AC",
                  card=card, n=n, freqs=F, runs={}, static_pivot={})
    pat = ckt.pattern()
    v0 = np.zeros(n)
    g_dc = GLU(CSC(pat.n, pat.indptr, pat.indices,
                   ckt.assemble(v0, v0, 0.0, 0.0)[0]), **kw)
    dc = g_dc._factorizer.step_kinds
    res_by = {}
    for esc in ("ladder", "none"):
        reset_counts()
        t0 = time.perf_counter()
        res = ac_sweep(ckt, freqs, escalation=esc, **kw)
        wall_s = time.perf_counter() - t0
        k1, k2, k3 = launch_counts()
        it, n_ac = res.op_newton_iters, res.n_batched_factorizations
        vals_ac, rhs_ac = ckt.assemble_ac(res.op_point, freqs)
        ac = GLU(CSC(pat.n, pat.indptr, pat.indices, vals_ac[0]),
                 dtype=torch.complex128, **kw)._factorizer.step_kinds
        err, berr, normal = _ac_point_checks(ckt, res)
        log(f"ac sweep ({esc}): n={n}, F={F} points, operating point in {it} "
            f"Newton iteration(s) (converged {res.op_converged}), {n_ac} "
            f"batched AC factorization(s), K1 launches {k1}, K2 {k2}, K3 {k3}, "
            f"ladder {res.ladder_counts}; max_backward_error "
            f"{res.max_backward_error:.3e}; {int(normal.sum())} of {F} points "
            f"with every voltage a normal float64 (berr there at most "
            f"{berr[normal].max():.3e}; the other points' berr "
            f"{berr[~normal].tolist()}); error against scipy splu at most "
            f"{err.max():.3e}; "
            f"setup {res.setup_seconds:.3f} s, solve {res.solve_seconds:.3f} "
            f"s ({res.solve_seconds / F * 1e3:.3f} ms a point), wall "
            f"{wall_s:.3f} s; steps DC {dc}, AC {ac}")
        assert res.op_converged
        assert res.voltages.shape == (F, n) and np.isfinite(res.voltages).all()
        assert err.max() < 1e-9, err
        assert berr[normal].max() <= 1e-10 and normal[0], berr
        assert dc.count("run") == ac.count("run") == 1
        assert k2 == it * dc.count("dense") and k1 - it >= n_ac and k3 >= 1, (
            k1, k2, k3)
        rungs = res.ladder_counts
        if esc == "none":
            assert n_ac == 1 and (k1, k3) == (it + 1, ac.count("dense")) == \
                (it + 1, 1), (k1, k3)
            assert not any(rungs.values()), rungs
        else:
            # each ladder rung climbed in the AC phase rebuilds its solver
            assert rungs["refactorize"] == it + 1 and \
                rungs["rescale"] + rungs["bump"] + rungs["replan"] == n_ac - 1
            assert (k1, k3) == (it + n_ac, n_ac) or n_ac > 1, (k1, k3)
        eager = ac_sweep(ckt, freqs, escalation=esc, jit_schedule=False, **kw)
        assert eager.voltages.tobytes() == res.voltages.tobytes()
        assert eager.ladder_counts == res.ladder_counts
        log(f"ac sweep ({esc}): {n_ac} batched K1 and {n_ac} batched K3 "
            f"launch(es) in the AC phase, one K1 and one K2 launch per DC "
            f"Newton factorization; voltages and ladder counts bit-identical "
            f"to the sweep with the steps one by one (solve "
            f"{eager.solve_seconds:.3f} s)")
        report["runs"][esc] = dict(
            op_newton_iters=it, n_batched_factorizations=n_ac,
            k1_launches=k1, k2_launches=k2, k3_launches=k3,
            ladder_counts=res.ladder_counts,
            max_backward_error=res.max_backward_error,
            points_all_normal=int(normal.sum()),
            max_berr_all_normal=float(berr[normal].max()),
            max_rel_err_scipy=float(err.max()),
            setup_s=res.setup_seconds, solve_s=res.solve_seconds,
            ms_per_point=res.solve_seconds / F * 1e3, wall_s=wall_s,
            eager_solve_s=eager.solve_seconds)
        res_by[esc] = res

    # the same F points again on a warmed solver (one replay for the batched
    # factorization), and as F single complex GLU solves
    res = res_by["none"]
    vals_ac, rhs_ac = ckt.assemble_ac(res.op_point, freqs)
    g_ac = GLU(CSC(pat.n, pat.indptr, pat.indices, vals_ac[0]),
               dtype=torch.complex128, **kw)
    g_ac.refactorize_solve(vals_ac, rhs_ac, rhs_pattern=nodes)
    steady_ms = clock.median_ms(lambda: g_ac.refactorize_solve(
        vals_ac, rhs_ac, rhs_pattern=nodes), reps=3)
    x_steady = g_ac.refactorize_solve(vals_ac, rhs_ac, rhs_pattern=nodes)
    assert g_ac.solve_info["n_dispatches"] == 1
    assert x_steady.tobytes() == res.voltages.tobytes()
    g1 = GLU(CSC(pat.n, pat.indptr, pat.indices, vals_ac[0]),
             dtype=torch.complex128, **kw)
    g1.factorize(vals_ac[0]).solve(rhs_ac[0], rhs_pattern=nodes)

    def singles():
        return np.stack([g1.factorize(vals_ac[k]).solve(rhs_ac[k],
                                                        rhs_pattern=nodes)
                         for k in range(F)])

    single_ms = clock.median_ms(singles, reps=3)
    diff = float(np.abs(singles() - res.voltages).max()
                 / np.abs(res.voltages).max())
    assert diff < 1e-9, diff
    report.update(steady_ms=steady_ms, single_glu_ms=single_ms,
                  single_glu_max_rel_diff=diff)
    log(f"ac sweep: on a warmed solver {steady_ms:.3f} ms for the {F} points "
        f"({steady_ms / F:.4f} ms a point; bit-identical), against "
        f"{single_ms:.3f} ms for {F} single GLU factorize + refined solve "
        f"calls ({single_ms / F:.4f} ms a point; within {diff:.1e})")

    # static pivoting: the complex robust batched K1 inside the graph
    reset_counts()
    res_p = ac_sweep(ckt, freqs, static_pivot=PIVOT_EPS, escalation="none",
                     **kw)
    kp = launch_counts()
    eager_p = ac_sweep(ckt, freqs, static_pivot=PIVOT_EPS, escalation="none",
                       jit_schedule=False, **kw)
    assert res_p.voltages.tobytes() == eager_p.voltages.tobytes()
    assert res_p.voltages.tobytes() == res.voltages.tobytes()
    ac_launches = kp[0] - res_p.op_newton_iters * dc.count("run")
    assert ac_launches == 1 and kp[2] == 1, kp
    rec = None
    for eps in (PIVOT_EPS, PIVOT_EPS_BUMPS_AC):
        gp = GLU(CSC(pat.n, pat.indptr, pat.indices, vals_ac[0]),
                 dtype=torch.complex128, static_pivot=eps, **kw)
        gpe = GLU(CSC(pat.n, pat.indptr, pat.indices, vals_ac[0]),
                  dtype=torch.complex128, static_pivot=eps,
                  jit_schedule=False, **kw)
        for _ in range(2):
            xp = gp.refactorize_solve(vals_ac, rhs_ac, rhs_pattern=nodes)
        assert gp.solve_info["n_dispatches"] == 1
        xpe = gpe.refactorize_solve(vals_ac, rhs_ac, rhs_pattern=nodes)
        bumps = gp.solve_info["n_perturbed"].tolist()
        assert bumps == gpe.solve_info["n_perturbed"].tolist(), eps
        assert xp.tobytes() == xpe.tobytes() and np.isfinite(xp).all(), eps
        if eps == PIVOT_EPS:
            assert not any(bumps)
        else:
            assert sum(bumps) > 0
            rec = record_kernel_inputs(gpe, vals_ac, batched=True)
        report["static_pivot"][str(eps)] = dict(n_perturbed_sum=sum(bumps),
                                                n_perturbed_max=max(bumps))
        log(f"ac sweep static pivot eps={eps:g}: {F} points, one replay for "
            f"the batched factorization, bit-identical to the steps one by "
            f"one with equal (F,) bump counts (sum {sum(bumps)}, max "
            f"{max(bumps)})")
    ent = robust_k1_entry(dev, clock, rec["k1"], dict(
        matrix=report["matrix"], k1_launches=ac_launches))
    ent["frequencies"] = F
    return report, ent



# phase 23: complex values in the native layout
NATIVE_TOL = 1e-12           # native against planar, of the largest entry
NATIVE_BATCH = 8


def _rel_max(a, b) -> float:
    """max |a - b| over max |b|, as numpy arrays or tensors."""
    a, b = (t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
            for t in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def drive_native(dev, clock, card):
    """Phase 23: complex values in the native layout on rajat12_ac (single,
    then B = 8 frequencies) and on phase 14's AC sweep; the counters at 0
    just before each path and read just after."""
    from repro_torch import GLU
    from repro_torch.circuit import ac_sweep, rc_grid_circuit
    from repro_torch.kernels import dense_lu_planar
    from repro_torch.kernels.ref import dense_lu_planar_ref, lu_backward_error
    from repro_torch.sparse import CSC

    t_phase = time.perf_counter()
    A = make_matrix("rajat12_ac")
    rng = np.random.default_rng(SEED + 23)
    b = rng.normal(size=A.n) + 1j * rng.normal(size=A.n)
    kw = dict(dtype=torch.complex128, layout="native")
    report = dict(matrix="rajat12_ac", card=card, layout="native")

    # -- single: K1 never, K3 once a factorization --------------------------
    vals_set = [np.asarray(A.data)] + refactor_values("rajat12_ac", A, rng)
    reset_counts()
    g = GLU(A, **kw)
    per = []
    for i, new in enumerate(vals_set):
        before = launch_counts()
        g.factorize(new)
        after = launch_counts()
        per.append(tuple(a - c for a, c in zip(after, before)))
        if i:
            assert g.solve_info["n_dispatches"] == 1, g.solve_info
    x = g.solve(b, refine=2)
    k1, k2, k3 = launch_counts()
    fz = g._factorizer
    info = g.solve_info
    assert info["layout"] == "native", info
    assert "layout='native'" in info["kernels_disabled_reason"], info
    assert set(fz.step_kinds) == {"flat", "dense"} and \
        fz.step_kinds[-1] == "dense", fz.step_kinds
    assert per == [(0, 0, 1)] * len(vals_set), per
    assert (k1, k2, k3) == (0, 0, len(vals_set)), (k1, k2, k3)
    assert g.plan_from_cache, "rajat12_ac's plan should come from the cache"
    S = A.to_scipy()
    S.data = vals_set[-1]
    res = float(np.abs(S @ x - b).max() / np.abs(b).max())
    assert info["converged"] and res < 1e-9, (res, info)
    gp = GLU(A, dtype=torch.complex128)
    log(f"native rajat12_ac: {len(vals_set)} factorizations with K1 "
        f"launches {k1}, K2 {k2}, K3 {k3} (one a factorization), "
        f"{fz.step_kinds.count('flat')} flat steps and the dense tail "
        f"(planar route: steps {gp._factorizer.step_kinds}); refine=2 "
        f"residual {res:.3e} < 1e-9; reason: "
        f"{info['kernels_disabled_reason']}")

    # -- replays bit for bit the steps one by one; against the planar route -
    ge = GLU(A, jit_schedule=False, **kw)
    planar_err = 0.0
    for new in vals_set:
        x = g.factorize(new).solve(b)
        xe = ge.factorize(new).solve(b)
        assert torch.equal(g.factorized_values(), ge.factorized_values())
        assert x.tobytes() == xe.tobytes()
        planar_err = max(planar_err, _rel_max(
            g.factorized_values(), gp.factorize(new).factorized_values()))
    assert g.solve(b, refine=2).tobytes() == ge.solve(b, refine=2).tobytes()
    assert planar_err < NATIVE_TOL, planar_err
    log(f"native rajat12_ac: replays bit-identical to the steps one by one "
        f"({ge.solve_info['n_dispatches']} steps), factors within "
        f"{planar_err:.3e} of the planar route's (bar {NATIVE_TOL:g})")
    report.update(k1_launches=k1, k2_launches=k2, k3_launches=k3,
                  factorizations=len(vals_set), steps=len(fz.step_kinds),
                  refined_residual=res, max_rel_diff_planar=planar_err)

    # -- K3 on this route's recorded tile -------------------------------------
    rec = record_kernel_inputs(ge, vals_set[0])
    assert len(rec["k3"]) == 1 and not rec["k1"] and not rec["k2"], rec.keys()
    tile = rec["k3"][0]
    got = dense_lu_planar(tile)
    err = compare(got, dense_lu_planar_ref(tile), K2_TOL["float64"])
    bwd = lu_backward_error(tile, got)
    bwd_tol = K2_BWD * tile.shape[-1] * torch.finfo(tile.dtype).eps
    assert bwd <= bwd_tol, (bwd, bwd_tol)
    report.update(k3_tile_N=int(tile.shape[-1]), k3_max_abs_err=err,
                  k3_backward_error=bwd)
    log(f"native rajat12_ac: K3 on the recorded (2, {tile.shape[-1]}, "
        f"{tile.shape[-1]}) tile against its plain version: max abs err "
        f"{err:.3e}, backward error {bwd:.3e} <= {bwd_tol:.3e}")

    # -- timings: replays of both layouts ------------------------------------
    bp = torch.as_tensor((b * g.Dr)[g._inv_row], dtype=g.dtype, device=dev)
    g.factorize(vals_set[0])
    gp.factorize(vals_set[0])
    times = dict(
        native_factorize_ms=clock.ms(g._factorizer.run, reps=20),
        planar_factorize_ms=clock.ms(gp._factorizer.run, reps=20),
        native_solve_ms=clock.ms(lambda: g._solver.solve(g._vals, bp),
                                 reps=20),
        planar_solve_ms=clock.ms(lambda: gp._solver.solve(gp._vals, bp),
                                 reps=20))
    report.update(times)
    log(f"native rajat12_ac: one replay each, CUDA events: factorize native "
        f"{times['native_factorize_ms']:.4f} ms, planar "
        f"{times['planar_factorize_ms']:.4f} ms; solve native "
        f"{times['native_solve_ms']:.4f} ms, planar "
        f"{times['planar_solve_ms']:.4f} ms ({card})")

    # -- B = 8 frequencies ----------------------------------------------------
    B = NATIVE_BATCH
    batch = batch_values("rajat12_ac", A, B, rng)
    bs = rng.normal(size=(B, A.n)) + 1j * rng.normal(size=(B, A.n))
    gb = GLU(A, **kw)
    gbe = GLU(A, jit_schedule=False, **kw)
    gb.factorize_batched(batch)          # the warm-up and the capture
    reset_counts()
    gb.factorize_batched(batch)
    xb = gb.solve_batched(bs)
    kb = launch_counts()
    assert kb == (0, 0, 1) and gb.solve_info["n_dispatches"] == 1, kb
    resid = _residuals(A, batch, xb, bs)
    assert max(resid) < 1e-9, resid
    fb = gb.factorized_values_batched()
    assert torch.equal(fb, gbe.factorize_batched(batch)
                       .factorized_values_batched())
    assert xb.tobytes() == gbe.solve_batched(bs).tobytes()
    for k in range(B):
        assert torch.equal(fb[k], ge.factorize(batch[k]).factorized_values()), k
    report["batched"] = dict(B=B, k1_launches=kb[0], k3_launches=kb[2],
                             max_residual=max(resid),
                             factorize_ms=clock.ms(gb._factorizer.run_batched,
                                                   reps=10))
    log(f"native rajat12_ac B={B}: one batched factorization with K1 {kb[0]} "
        f"and K3 {kb[2]} launches, residuals at most {max(resid):.3e} < 1e-9, "
        f"bit-identical to the steps one by one and each row to one GLU; "
        f"{report['batched']['factorize_ms']:.4f} ms a batched replay")

    # -- the AC sweep ----------------------------------------------------------
    c = AC_SWEEP
    ckt = rc_grid_circuit(c["nx"], c["ny"], with_diodes=True, seed=0)
    ckt.add_ac_current_source(c["node"], 0, 1.0)
    freqs = np.logspace(*c["decades"], c["points"])
    # one batched AC factorization: the ladder's rebuilds on the points
    # whose far voltages underflow (phase 14 drives the ladder) would
    # take this phase past its budget
    skw = dict(refine=c["refine"], escalation="none")
    report["single_batched_s"] = time.perf_counter() - t_phase
    reset_counts()
    t0 = time.perf_counter()
    nat = ac_sweep(ckt, freqs, layout="native", **skw)
    wall_s = time.perf_counter() - t0
    ks = launch_counts()
    it, n_ac = nat.op_newton_iters, nat.n_batched_factorizations
    pat = ckt.pattern()
    dc = GLU(CSC(pat.n, pat.indptr, pat.indices,
                 ckt.assemble(nat.op_point, nat.op_point, 0.0, 0.0)[0]),
             refine=c["refine"])._factorizer.step_kinds
    ac = GLU(CSC(pat.n, pat.indptr, pat.indices,
                 ckt.assemble_ac(nat.op_point, freqs[:1])[0][0]),
             refine=c["refine"], **kw)._factorizer.step_kinds
    # the DC Newton loop's real factorizations keep their K1 run and K2;
    # each batched AC factorization is flat steps and one K3 launch
    assert ac.count("dense") == 1 and set(ac) == {"flat", "dense"}, ac
    assert n_ac == 1 and ks == (it * dc.count("run"), it * dc.count("dense"),
                                1), (ks, it, n_ac, dc)
    assert nat.op_converged
    err, _, _ = _ac_point_checks(ckt, nat)
    assert nat.voltages.shape == (len(freqs), ckt.n)
    assert np.isfinite(nat.voltages).all() and err.max() < 1e-9, err
    planar = ac_sweep(ckt, freqs, **skw)
    scale = np.abs(planar.voltages).max(axis=1, keepdims=True)
    lay_err = float((np.abs(nat.voltages - planar.voltages) / scale).max())
    assert lay_err < NATIVE_TOL, lay_err
    eager = ac_sweep(ckt, freqs, layout="native", jit_schedule=False, **skw)
    assert eager.voltages.tobytes() == nat.voltages.tobytes()
    report["ac_sweep"] = dict(
        n=ckt.n, freqs=len(freqs), op_newton_iters=it,
        n_batched_factorizations=n_ac, k1_launches=ks[0], k2_launches=ks[1],
        k3_launches=ks[2], max_rel_err_scipy=float(err.max()),
        max_rel_diff_planar=lay_err, solve_s=nat.solve_seconds,
        planar_solve_s=planar.solve_seconds, wall_s=wall_s)
    log(f"native ac sweep: n={ckt.n}, {len(freqs)} points, K1 {ks[0]} (the "
        f"{it} DC factorizations), K2 {ks[1]}, K3 {ks[2]} ({n_ac} batched AC "
        f"factorization(s)); error against scipy splu at most "
        f"{err.max():.3e}; within {lay_err:.3e} of the planar sweep; "
        f"bit-identical to the steps one by one; solve {nat.solve_seconds:.3f}"
        f" s (planar {planar.solve_seconds:.3f} s)")
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 23: {report['phase_s']:.1f} s")
    return report


# phase 24: the examples in this process on the card, at their defaults
EXAMPLES = ("quickstart", "circuit_transient", "transient_sweep", "ac_sweep",
            "serve_lm", "train_lm")


def drive_examples(tmp) -> dict:
    """Phase 24: each ``examples/torch_<name>.py``'s ``main`` on the card at
    its defaults (the training example's checkpoints and metrics under
    ``tmp``); its lines are printed as it runs."""
    import importlib.util

    root = Path(__file__).resolve().parent / "examples"
    report = {}
    for name in EXAMPLES:
        path = root / f"torch_{name}.py"
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = []
        if name == "train_lm":
            argv = ["--ckpt-dir", str(Path(tmp) / "train_lm"),
                    "--metrics-out", str(Path(tmp) / "train_lm.json")]
        log(f"-- examples/torch_{name}.py {' '.join(argv)}")
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if name == "quickstart":
            assert max(out["residuals"]) < 1e-9, out["residuals"]
            summary = dict(max_residual=max(out["residuals"]))
        elif name == "serve_lm":
            assert out["batch"].shape == (4, 12) and len(out["requests"]) == 4
            summary = dict(batch=list(out["batch"].shape))
        elif name == "train_lm":
            assert len(out) == 11 and out[-1]["loss"] < out[0]["loss"], out
            summary = dict(first_loss=out[0]["loss"], last_loss=out[-1]["loss"])
        else:
            assert np.isfinite(out.voltages).all()
            summary = dict(voltages=list(out.voltages.shape))
        report[name] = dict(seconds=seconds, **summary)
        log(f"examples/torch_{name}.py: {seconds:.2f} s {summary}")
    return report


# phase 15: the matrices of the detection, ablation and verification runs,
# and the paper's Table III variants of the factorizer
PHASE15_MATRICES = ("grid64", "rajat12_like")
MODE_VARIANTS = (("default", {}),
                 ("noflat", dict(disable_modes=("flat",))),
                 ("nopanel", dict(disable_modes=("panel",))),
                 ("nok1modes", dict(disable_modes=("segmented", "panel"))),
                 ("allflat", dict(mode_override="flat")))
# factors of a variant against the default variant's: relative, max-norm
MODE_FACTOR_TOL = 1e-10


def _edge_keys(n, src, dst):
    return np.unique(np.asarray(src, dtype=np.int64) * n + dst)


def drive_detection(name):
    """Phase 15 (a) for one matrix, on this machine's host (numpy, not the
    card): the paper's detectors on the plan's filled pattern (from the
    plan cache), their seconds and edge counts, the set relations
    ``upattern ∪ doubleu ⊇ exact`` and ``relaxed ⊇ exact``, the relaxed
    levels against the plan's, the levels' modes (A flat, B segmented,
    C panel) and ``level_stats`` maxima."""
    from repro_torch.core import (
        dependencies_doubleu,
        dependencies_exact,
        dependencies_relaxed,
        dependencies_upattern,
        level_stats,
        levelize_relaxed,
        plan_factorization,
    )

    sp, _, from_cache = plan_factorization(make_matrix(name))
    P, n = sp.pattern, sp.n
    secs, keys = {}, {}
    for fn in (levelize_relaxed, dependencies_relaxed, dependencies_upattern,
               dependencies_exact, dependencies_doubleu):
        t0 = time.perf_counter()
        out = fn(P)
        secs[fn.__name__] = time.perf_counter() - t0
        if fn is levelize_relaxed:
            lv = out
        else:
            keys[fn.__name__.split("_")[1]] = _edge_keys(n, *out)
    exact = keys["exact"]
    assert np.setdiff1d(exact, np.union1d(keys["upattern"],
                                          keys["doubleu"])).size == 0, name
    assert np.setdiff1d(exact, keys["relaxed"]).size == 0, name
    assert np.array_equal(lv.levels, sp.levelization.levels), name
    modes = [s.mode for s in sp.fplan.segments]
    stats = level_stats(P, lv)
    rep = dict(matrix=name, clock="host (numpy), not the card",
               plan_from_cache=from_cache, n=n, nnz_filled=P.nnz,
               levels=lv.num_levels, seconds=secs,
               edges={k: int(len(v)) for k, v in keys.items()},
               modes={m: modes.count(m) for m in ("flat", "segmented",
                                                   "panel")},
               level_stats_max=dict(columns=int(stats[:, 0].max()),
                                    subcolumns=int(stats[:, 1].max()),
                                    updates=int(stats[:, 2].max())))
    log(f"{name} detection (host numpy): " + ", ".join(
        f"{k} {v:.4f} s" for k, v in secs.items()) + f"; edges {rep['edges']}"
        f"; upattern ∪ doubleu ⊇ exact and relaxed ⊇ exact ok; relaxed "
        f"levels equal the plan's ({lv.num_levels}); modes {rep['modes']}; "
        f"level_stats maxima {rep['level_stats_max']}")
    return rep


def drive_modes(dev, clock, card, name):
    """Phase 15 (b) for one matrix: the paper's Table III on the card.
    Each variant of :data:`MODE_VARIANTS` is a ``TorchFactorizer`` on the
    cached plan (the replays) and its twin with ``jit_schedule=False`` (the
    steps one by one), driven with every launch counter at 0: step kinds,
    K1 and K2 launches per factorization (read from one replay), replay and
    step times with CUDA events (values on the card), device kernels and
    busy share per factorization (torch.profiler), the residual of a solve
    of the system the factors describe, the replay bit for bit the steps
    one by one, and the factors within ``MODE_FACTOR_TOL`` of the default
    variant's.  For grid64's ``noflat`` variant K1 runs a new shape (the
    flat levels joined to the run): it is held bit for bit against its
    plain version on the path's recorded input and timed as a kernel
    entry.  Returns the rows and that entry (or None)."""
    from repro_torch import GLU
    from repro_torch.core import TorchFactorizer, plan_factorization

    A = make_matrix(name)
    sp, _, _ = plan_factorization(A)
    g = GLU.from_plan(sp, A)                 # the scaled permuted values
    vals = np.asarray(g._A_perm.data)
    S = g._A_perm.to_scipy()
    bp_host = np.random.default_rng(SEED + 15).normal(size=A.n)
    bp = torch.as_tensor(bp_host, device=dev)
    rows, entry, v_default = [], None, None
    for label, opts in MODE_VARIANTS:
        reset_counts()
        f = TorchFactorizer(sp.fplan, device=dev, **opts)
        fe = TorchFactorizer(sp.fplan, device=dev, jit_schedule=False, **opts)
        f.factorize(vals)                    # warm-up (steps) and capture
        first = launch_counts()
        reset_counts()
        v = f.factorize(vals).clone()        # one replay
        torch.cuda.synchronize(dev)
        k1, k2, k3 = launch_counts()
        steps = f.step_kinds
        assert f.last_n_dispatches == 1, (name, label)
        assert (k1, k2 + k3) == (steps.count("run"), steps.count("dense")), \
            (name, label, k1, k2, steps)
        assert first[0] == k1 and first[1] + first[2] == k2 + k3
        ve = fe.factorize(vals).clone()
        assert torch.equal(v, ve), (name, label)
        if v_default is None:
            v_default = v
        rel = ((v - v_default).abs().max() / v_default.abs().max()).item()
        assert rel <= MODE_FACTOR_TOL, (name, label, rel)
        xp = g._solver.solve(v, bp).cpu().numpy()
        res = float(np.abs(S @ xp - bp_host).max() / np.abs(bp_host).max())
        assert np.isfinite(xp).all() and res < 1e-9, (name, label, res)
        replay_ms = clock.ms(f.run, reps=20)
        steps_ms = clock.ms(fe.run, reps=5)
        for _ in range(4):          # the profiler may lose a replay's window
            prof = _profile(dev, f.run)
            if "kernels" in prof:
                break
        eager, _ = _profile_until(dev, fe.run, {
            "dense_lu_kernels": steps.count("dense"),
            "level_run_kernels": steps.count("run")})
        row = dict(variant=label, options={k: list(v) if isinstance(v, tuple)
                                           else v for k, v in opts.items()},
                   steps=len(steps) + 1, step_kinds=dict(
                       flat=steps.count("flat"), run=steps.count("run"),
                       dense=steps.count("dense")),
                   k1_levels=f.kinds.count("pallas"), k1_launches=k1,
                   k2_launches=k2, k3_launches=k3,
                   kernels_disabled_reason=f.kernels_disabled_reason,
                   replay_ms=replay_ms, steps_ms=steps_ms,
                   replay_kernels=prof.get("kernels", "not measured"),
                   replay_busy_ms=prof.get("device_busy_ms", "not measured"),
                   steps_kernels=eager.get("kernels"),
                   steps_busy_ms=eager.get("device_busy_ms"),
                   factor_rel_diff=rel, residual=res,
                   replay_equals_steps=True)
        if "device_busy_ms" in prof:
            row["replay_busy_share"] = prof["device_busy_ms"] / replay_ms
        rows.append(row)
        log(f"{name} {label}: {row['steps']} steps ({row['step_kinds']}, "
            f"{row['k1_levels']} K1 levels), K1 {k1} and K2 {k2} launches a "
            f"factorization; replay {replay_ms:.4f} ms, steps one by one "
            f"{steps_ms:.4f} ms; device kernels {row['replay_kernels']} a "
            f"replay ({row['steps_kernels']} one by one), busy share "
            f"{row.get('replay_busy_share', 'not measured')}; residual "
            f"{res:.3e}; replay "
            f"bit-identical to the steps; factors within {rel:.2e} of the "
            f"default's")
        if name == "grid64" and label == "noflat":
            rec = record_kernel_inputs(fe, vals)["k1"]
            runs = [gr.arrays[0] for gr in fe._groups if gr.kind == "run"]
            entry = _k1_entry(dev, clock, rec, dict(
                matrix=name, planes=1, k1_launches=k1,
                k1_levels=row["k1_levels"],
                k1_updates=sum(r.n_updates for r in runs),
                k1_rows=sum(len(r.host["rows"]) for r in runs)))
            entry.update(variant="noflat", matrix=name)
        del f, fe
    return dict(matrix=name, card=card, variants=rows), entry


def drive_verify(dev, name):
    """Phase 15 (c) for one matrix: ``GLU(verify="full")`` on the card.
    The report must be clean and hold the graph audit (run, not skipped);
    verification seconds on the host are the build's excess over
    ``GLU(verify="off")``'s; factors and solutions bit for bit those of the
    unverified ``GLU``; with ``jit_schedule=False`` the audit flags
    ``AUDIT_DISPATCH``."""
    from repro_torch import GLU
    from repro_torch.analysis import audit_factorize, audit_trisolve

    A = make_matrix(name)
    b = np.random.default_rng(SEED + 16).normal(size=A.n)
    t0 = time.perf_counter()
    go = GLU(A)
    t_off = time.perf_counter() - t0
    t0 = time.perf_counter()
    gv = GLU(A, verify="full")
    t_full = time.perf_counter() - t0
    rep = gv.verify_report
    assert rep.ok and not rep.skipped, str(rep)
    assert {"audit_factorize", "audit_trisolve", "exec_schedule",
            "trisolve_schedule", "races"} <= set(rep.checks), rep.checks
    new = newton_values(A, np.random.default_rng(SEED + 17))
    for vals in (None, new):
        xo = go.factorize(vals).solve(b)
        xv = gv.factorize(vals).solve(b)
        assert torch.equal(go.factorized_values(), gv.factorized_values())
        assert xo.tobytes() == xv.tobytes()
    summary = gv.solve_info["verify_report"]
    assert summary["ok"] and summary["skipped"] == {}, summary
    ge = GLU(A, jit_schedule=False)
    dispatch = (audit_factorize(ge._factorizer).codes
                | audit_trisolve(ge._solver).codes)
    assert dispatch == {"AUDIT_DISPATCH"}, dispatch
    out = dict(matrix=name, checks=rep.checks, n_checks=len(rep.checks),
               violations=len(rep.violations), glu_build_off_s=t_off,
               glu_build_full_s=t_full, verify_s=t_full - t_off,
               bits_equal_off=True, eager_audit_codes=sorted(dispatch),
               clock="host")
    log(f"{name} GLU(verify='full'): {rep}; build {t_full:.3f} s against "
        f"{t_off:.3f} s unverified (verification {t_full - t_off:.3f} s on "
        f"the host); factors and solutions bit-identical to verify='off'; "
        f"jit_schedule=False flagged {sorted(dispatch)}")
    return out


# -- phase 16: sharded sweeps, Matrix Market, the on-disk plan cache, the
# multi-domain chip, the left-looking baseline and the CLI -----------------

# (matrix, B, shards, static_pivot): each sharded batch against the
# unsharded one on the card; the shards are the card repeated (emulated)
SHARDED = [("grid64", 16, 4, None), ("grid64", 7, 4, None),
           ("rajat12_like", 16, 4, None), ("rajat12_like", 7, 4, None),
           ("rajat12_ac", 8, 2, None), ("grid64", 4, 2, PIVOT_EPS_BUMPS)]
SHARDED_SWEEP = dict(nx=64, ny=64, t_end=0.05, dt=5e-3, refine=1,
                     scales=np.linspace(0.9, 1.1, 4), shards=4)
# the multi-domain chip's one-node excitation: the middle of the first
# 400-node domain (the 1,600-node domain comes first)
MULTI_DOMAIN_NODE = 1600 + 200
CLI_ARGS = ["--nx", "16", "--ny", "16", "--t-end", "0.02", "--dt", "0.005"]


def drive_sharded(dev, clock, card):
    """Phase 16 (a): the machine's own mesh, then each ``SHARDED`` batch
    on an emulated mesh of the card repeated: every row bit for bit the
    unsharded batch's (factors and solutions), one factorization replay
    and one solve replay a shard, K1 and K2/K3 launched once a shard and
    run; per-call times of both, labelled emulated; then
    ``transient_sweep(mesh=)`` against the unsharded sweep."""
    from repro_torch import GLU
    from repro_torch.distributed import make_scenario_sharding, make_sweep_mesh

    own = make_sweep_mesh()
    out = dict(card=card, own_mesh_devices=len(own.devices),
               own_mesh_sharding=None if make_scenario_sharding(own) is None
               else make_scenario_sharding(own).n_shards, cases=[])
    g_own = GLU(make_matrix("grid64"), mesh=own)
    assert g_own.n_devices == (1 if len(own.devices) == 1
                               else len(own.devices)), g_own.n_devices
    out["own_mesh_n_devices"] = g_own.n_devices
    log(f"sharded: make_sweep_mesh() holds {len(own.devices)} card(s) -> "
        f"GLU.n_devices {g_own.n_devices}")
    del g_own
    rng = np.random.default_rng(SEED + 20)
    torch.cuda.reset_peak_memory_stats(dev)
    for name, B, k, eps in SHARDED:
        A = make_matrix(name)
        cplx = np.iscomplexobj(A.data)
        dtype = torch.complex128 if cplx else torch.float64
        mesh = make_sweep_mesh(devices=[dev] * k)
        g = GLU(A, dtype=dtype, mesh=mesh, static_pivot=eps)
        g0 = GLU(A, dtype=dtype, static_pivot=eps)
        batch = batch_values(name, A, B, rng)
        bs = rng.normal(size=(B, A.n)) + (1j * rng.normal(size=(B, A.n))
                                          if cplx else 0.0)
        g.refactorize_solve(batch, bs)          # warm-up: capture the graphs
        g0.refactorize_solve(batch, bs)
        steps = g._factorizer.step_kinds
        reset_counts()
        x = g.refactorize_solve(batch, bs)
        torch.cuda.synchronize(dev)
        k1, k2, k3 = launch_counts()
        info = g.solve_info
        x0 = g0.refactorize_solve(batch, bs)
        assert x.tobytes() == x0.tobytes(), (name, B, k)
        assert torch.equal(g.factorized_values_batched(),
                           g0.factorized_values_batched()), (name, B, k)
        assert info["n_devices"] == k and info["n_dispatches"] == 1 \
            and info["solve_dispatches"] == 1, info
        assert info["batch_spec"] == "PartitionSpec('data',)", info
        assert k1 == k * steps.count("run") and \
            k2 + k3 == k * steps.count("dense"), (name, k1, k2, k3, steps)
        for key in ("pivot_growth", "min_diag"):
            assert np.asarray(info[key]).shape == (B,), (key, info[key])
            np.testing.assert_array_equal(info[key], g0.solve_info[key])
        case = dict(matrix=name, batch=B, shards=k, static_pivot=eps,
                    padded_to=-(-B // k) * k, k1_launches=k1,
                    k2_launches=k2, k3_launches=k3)
        if eps is not None:
            n_pert = info["n_perturbed"]
            np.testing.assert_array_equal(n_pert, g0.solve_info["n_perturbed"])
            pad = case["padded_to"] - B
            assert info["n_perturbed_global"] == int(
                n_pert.sum() + pad * n_pert[-1]), info
            assert n_pert.sum() > 0, n_pert
            case["n_perturbed"] = n_pert.tolist()
            case["n_perturbed_global"] = info["n_perturbed_global"]
        ms = clock.median_ms(lambda: g.refactorize_solve(batch, bs))
        ms0 = clock.median_ms(lambda: g0.refactorize_solve(batch, bs))
        prof = {key: {k: v for k, v in _profile(
                    dev, lambda: gg.refactorize_solve(batch, bs)).items()
                    if k != "top"} for key, gg in (("sharded", g),
                                                   ("unsharded", g0))}
        case.update(sharded_ms=ms, unsharded_ms=ms0, profile=prof,
                    timing="emulated (one card)")
        res = _residuals(A, batch, x, bs)
        case["max_residual"] = max(res)
        out["cases"].append(case)
        log(f"sharded {name} B={B} on {k} shards (padded to "
            f"{case['padded_to']}): rows bit-identical to the unsharded "
            f"batch (factors, solutions); per shard one factorization and "
            f"one solve replay; K1 {k1}, K2 {k2}, K3 {k3} launches a call; "
            f"max residual {max(res):.3e}; refactorize_solve "
            f"{ms:.3f} ms sharded against {ms0:.3f} ms unsharded, "
            f"emulated (one card); one call's device kernels and busy time "
            f"{prof['sharded']} sharded, {prof['unsharded']} unsharded"
            + ("" if eps is None else
               f"; n_perturbed {case['n_perturbed']}, n_perturbed_global "
               f"{case['n_perturbed_global']}"))
        del g, g0
    out["peak_memory_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"sharded: peak device memory {out['peak_memory_mib']:.1f} MiB")
    out["mixed"] = drive_mixed_mesh(dev)
    out["sweep"] = drive_sharded_sweep(dev)
    return out


def drive_mixed_mesh(dev):
    """Phase 16 (a): grid64 at B = 8 and B = 7 on a mesh that mixes the
    card with the CPU (and, on a host of several cards, the first and the
    last card), so that row blocks, gathers, the exact sum and the
    refinement's lockstep cross devices: every row within 1e-9 of the
    unsharded batch on the card (the CPU shards run the plain versions)."""
    from repro_torch import GLU
    from repro_torch.distributed import make_sweep_mesh

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    devices = [dev, "cpu", last, "cpu"]
    A = make_matrix("grid64")
    rng = np.random.default_rng(SEED + 24)
    g = GLU(A, mesh=make_sweep_mesh(devices=devices), static_pivot=PIVOT_EPS)
    g0 = GLU(A, static_pivot=PIVOT_EPS)
    out = dict(devices=[str(d) for d in g.mesh.devices], cases=[])
    for B in (8, 7):
        batch = batch_values("grid64", A, B, rng)
        bs = rng.normal(size=(B, A.n))
        x = g.refactorize_solve(batch, bs, refine=1)
        x0 = g0.refactorize_solve(batch, bs, refine=1)
        info, info0 = g.solve_info, g0.solve_info
        err = float(np.abs(x - x0).max() / np.abs(x0).max())
        ferr = compare(g.factorized_values_batched(),
                       g0.factorized_values_batched(), 1e-10)
        assert x.shape == (B, A.n) and err < 1e-9, err
        assert info["n_devices"] == 4 and info["n_perturbed"].shape == (B,)
        np.testing.assert_array_equal(info["n_perturbed"],
                                      info0["n_perturbed"])
        assert info["n_perturbed_global"] == int(
            info["n_perturbed"].sum() + (8 - B) * info["n_perturbed"][-1])
        assert info["refine_iters"].shape == (B,)
        out["cases"].append(dict(batch=B, max_rel_err=err,
                                 factor_err=ferr,
                                 n_perturbed_global=info["n_perturbed_global"]))
        log(f"mixed mesh {out['devices']}: grid64 B={B}, refined solutions "
            f"within {err:.3e} and factors within {ferr:.3e} of the "
            f"unsharded batch on the card, n_perturbed_global "
            f"{info['n_perturbed_global']}")
    return out


def drive_sharded_sweep(dev):
    """Phase 16 (a): ``transient_sweep`` of copies of the 64 x 64 grid on
    an emulated mesh of the card, bit for bit the unsharded sweep."""
    from repro_torch.circuit import rc_grid_circuit, transient_sweep
    from repro_torch.distributed import make_sweep_mesh

    c = SHARDED_SWEEP
    ckt = rc_grid_circuit(c["nx"], c["ny"], with_diodes=True, seed=0)
    kw = dict(t_end=c["t_end"], dt=c["dt"], refine=c["refine"],
              scales=c["scales"])
    want = transient_sweep(ckt, **kw)
    mesh = make_sweep_mesh(devices=[dev] * c["shards"])
    got = transient_sweep(ckt, mesh=mesh, **kw)
    assert got.n_devices == c["shards"] and want.n_devices == 1
    assert got.voltages.tobytes() == want.voltages.tobytes()
    assert np.array_equal(got.newton_iters, want.newton_iters)
    assert got.max_residual < 1e-8
    log(f"sharded transient_sweep: {len(kw['scales'])} copies of the "
        f"{c['nx']} x {c['ny']} grid on {c['shards']} emulated shards, "
        f"{len(got.times)} steps, {got.n_batched_factorizations} batched "
        f"factorizations: voltages bit-identical to the unsharded sweep; "
        f"loop {got.solve_seconds:.3f} s against {want.solve_seconds:.3f} s "
        f"unsharded, emulated (one card)")
    return dict(copies=len(kw["scales"]), shards=c["shards"],
                steps=len(got.times),
                n_batched_factorizations=got.n_batched_factorizations,
                sharded_loop_s=got.solve_seconds,
                unsharded_loop_s=want.solve_seconds,
                max_residual=got.max_residual, timing="emulated (one card)")


def drive_matrix_market(tmp):
    """Phase 16 (b): grid64 through ``write_matrix_market`` and
    ``read_matrix_market``: the same pattern and values, then factorized
    and solved on the card."""
    from repro_torch import GLU
    from repro_torch.sparse import read_matrix_market, write_matrix_market

    A = make_matrix("grid64")
    path = Path(tmp) / "grid64.mtx"
    t0 = time.perf_counter()
    write_matrix_market(path, A)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    A2 = read_matrix_market(path)
    t_read = time.perf_counter() - t0
    assert A2.n == A.n and np.array_equal(A2.indptr, A.indptr) \
        and np.array_equal(A2.indices, A.indices) \
        and np.asarray(A2.data).tobytes() == np.asarray(A.data).tobytes()
    b = np.random.default_rng(SEED + 21).normal(size=A2.n)
    g = GLU(A2)
    x = g.factorize().solve(b)
    res = g.residual(b, x)
    assert res < 1e-9, res
    log(f"matrix market: grid64 ({A.nnz} entries, "
        f"{path.stat().st_size} bytes) written in {t_write:.3f} s, read in "
        f"{t_read:.3f} s, same pattern and values; solved on the card to "
        f"residual {res:.3e}")
    return dict(nnz=A.nnz, bytes=path.stat().st_size, write_s=t_write,
                read_s=t_read, residual=res, clock="host")


def drive_plan_cache(tmp):
    """Phase 16 (c): grid64 planned cold into a fresh on-disk
    ``PlanCache`` and warm from a second one on the same directory; the
    rajat12_like plan built in phase 4 written and read back."""
    from repro_torch import GLU
    from repro_torch.core import PlanCache, plan_factorization

    d = Path(tmp) / "plans"
    A = make_matrix("grid64")
    t0 = time.perf_counter()
    cold, _, hit_cold = plan_factorization(A, cache=PlanCache(directory=d))
    t_cold = time.perf_counter() - t0
    warm_cache = PlanCache(directory=d)
    t0 = time.perf_counter()
    warm, _, hit_warm = plan_factorization(A, cache=warm_cache)
    t_warm = time.perf_counter() - t0
    assert not hit_cold and hit_warm and warm_cache.stats.disk_hits == 1
    n_arrays = _same_plan_arrays(cold, warm)
    # the plan read from disk factorizes to the cold plan's bits on the card
    a_data = newton_values(A, np.random.default_rng(SEED + 23))
    f_cold = GLU(A, plan_cache=PlanCache()).factorize(a_data)
    f_warm = GLU(A, plan_cache=warm_cache)
    assert f_warm.plan_from_cache and warm_cache.stats.disk_hits == 1
    f_warm.factorize(a_data)
    assert torch.equal(f_warm.factorized_values(), f_cold.factorized_values())
    log(f"plan cache: grid64 cold {t_cold:.3f} s (plan and write), warm "
        f"{t_warm:.3f} s from disk (disk_hits "
        f"{warm_cache.stats.disk_hits}); all {n_arrays} plan arrays equal "
        f"the cold plan's, and its factors on the card are the cold plan's "
        f"bit for bit")
    R = make_matrix("rajat12_like")
    plan, _, hit = plan_factorization(R)       # phase 4's, from memory
    assert hit
    build_s = plan.build_seconds["total"]
    free = shutil.disk_usage(d).free
    log(f"plan cache: {free / 2**30:.1f} GiB free where the plans go")
    put_cache = PlanCache(directory=d)
    t0 = time.perf_counter()
    put_cache.put(plan.key, plan)
    t_put = time.perf_counter() - t0
    get_cache = PlanCache(directory=d)
    t0 = time.perf_counter()
    back = get_cache.get(plan.key)
    t_get = time.perf_counter() - t0
    assert back is not None and get_cache.stats.disk_hits == 1
    n_arrays = _same_plan_arrays(plan, back)
    size = (d / f"{plan.key}.plan.npz").stat().st_size
    log(f"plan cache: rajat12_like written in {t_put:.3f} s and read back "
        f"in {t_get:.3f} s ({size / 2**20:.1f} MiB, disk_hits 1, all "
        f"{n_arrays} plan arrays equal) against its {build_s:.1f} s build")
    return dict(grid64_cold_s=t_cold, grid64_warm_s=t_warm,
                rajat12_write_s=t_put, rajat12_read_s=t_get,
                rajat12_build_s=build_s, rajat12_file_mib=size / 2**20,
                free_gib=free / 2**30, clock="host")


def _same_plan_arrays(p, q) -> int:
    """Asserts that two plans hold equal fields, arrays and scalars alike
    (the digest is a stored string, so it alone proves nothing); returns
    the number of fields."""
    from repro_torch.convert import plan_to_arrays

    a, b = plan_to_arrays(p), plan_to_arrays(q)
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    return len(a)


def drive_multi_domain(dev, clock):
    """Phase 16 (d): ``multi_domain_circuit()`` factorized and solved on
    the card, then a one-node ``rhs_pattern`` in a 400-node domain: the
    pruned replay bit for bit the full one, its levels and device kernels,
    and both replays' times."""
    from repro_torch import GLU
    from repro_torch.sparse import multi_domain_circuit

    A = multi_domain_circuit()
    t0 = time.perf_counter()
    g = GLU(A)
    t_plan = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 22)
    b = rng.normal(size=A.n)
    x = g.factorize().solve(b)
    res = g.residual(b, x)
    assert res < 1e-9, res
    node = MULTI_DOMAIN_NODE
    b1 = np.zeros(A.n)
    b1[node] = 1.0
    x_full = g.solve(b1)
    g.solve(b1, rhs_pattern=[node])                 # warm-up, capture
    x_pruned = g.solve(b1, rhs_pattern=[node])      # a replay
    assert g.solve_info["solve_dispatches"] == 1
    assert np.array_equal(x_pruned, x_full)
    sv, vals = g._solver, g._vals
    pp = g.row_map[[node]]
    fwd, bwd, fr, br = sv.schedule_for_pattern(pp)
    bp = torch.as_tensor((b1 * g.Dr)[g._inv_row], device=dev)
    full_ms = clock.ms(lambda: sv.solve(vals, bp), reps=10)
    ms = clock.ms(lambda: sv.solve(vals, bp, rhs_pattern=pp), reps=10)
    kern = _profile(dev, lambda: sv.solve(vals, bp, rhs_pattern=pp))
    full_kern = _profile(dev, lambda: sv.solve(vals, bp))
    out = dict(n=A.n, nnz=A.nnz, nnz_filled=g.nnz_filled, plan_s=t_plan,
               residual=res, node=node, fwd_reach=len(fr), bwd_reach=len(br),
               levels_kept=[len(fwd), len(bwd)],
               levels_full=[len(sv.fwd_levels), len(sv.bwd_levels)],
               kernels=kern.get("kernels"), full_kernels=full_kern.get("kernels"),
               pruned_ms=ms, full_ms=full_ms)
    log(f"multi_domain_circuit: n={A.n}, nnz {A.nnz} ({g.nnz_filled} "
        f"filled), planned in {t_plan:.1f} s, residual {res:.3e}; one-node "
        f"rhs_pattern at node {node}: reach {len(fr)} / {len(br)} of {A.n}, "
        f"levels kept {len(fwd)} / {len(bwd)} of {len(sv.fwd_levels)} / "
        f"{len(sv.bwd_levels)}, device kernels a solve {out['kernels']} "
        f"(full {out['full_kernels']}); pruned replay {ms:.4f} ms against "
        f"the full replay {full_ms:.4f} ms, bit-identical")
    return out


def drive_leftlooking():
    """Phase 16 (e): the paper's Algorithm 1 (``leftlooking_numpy``) on
    grid64's filled pattern against the port's factors on the card."""
    from repro_torch import GLU
    from repro_torch.core import leftlooking_numpy

    g = GLU(make_matrix("grid64"))
    vals0 = g.pattern.filled_csc(g._A_perm).data
    t0 = time.perf_counter()
    ll = leftlooking_numpy(g.pattern, vals0)
    t_ll = time.perf_counter() - t0
    f = g.factorize().factorized_values().cpu().numpy()
    diff = float(np.abs(ll - f).max())
    assert np.allclose(ll, f, rtol=1e-10, atol=1e-10), diff
    log(f"leftlooking_numpy: grid64's filled pattern ({g.nnz_filled} "
        f"entries) in {t_ll:.3f} s on the host, within {diff:.3e} of the "
        f"card's factors")
    return dict(nnz_filled=g.nnz_filled, host_s=t_ll, max_abs_diff=diff,
                clock="host")


def run_at_once(cmds, timeout=300) -> list:
    """Each command in a process of its own from the repo root, with
    ``src`` on the path, all started together: [(exit code, stdout,
    stderr, wall seconds)] in the commands' order.  A command still
    running at ``timeout`` is killed and raises."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))

    def one(cmd):
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                             env=env, timeout=timeout)
        return out.returncode, out.stdout, out.stderr, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        return list(pool.map(one, cmds))


def cli_cmd(module, args):
    return [sys.executable, "-m", module, *args]


def drive_cli(result):
    """Phase 16 (f): ``python -m repro_torch.launch.simulate`` in a
    subprocess on the card (``result`` of :func:`run_at_once`): exit 0,
    its two lines, residual < 1e-9."""
    rc, stdout, stderr, wall = result
    assert rc == 0, (rc, stderr[-2000:])
    lines = stdout.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("nodes: 256"), lines
    res = float(re.search(r"max residual (\S+)", lines[1]).group(1))
    assert res < 1e-9, res
    log(f"cli: -m repro_torch.launch.simulate {' '.join(CLI_ARGS)} -> exit 0 in "
        f"{wall:.1f} s: {lines[0]} | {lines[1]}")
    return dict(args=CLI_ARGS, lines=lines, max_residual=res, wall_s=wall,
                clock="host")


# -- phase 17: the LM serving path ---------------------------------------------
# bf16 peak of one H100 SXM (dense tensor-core rate, NVIDIA data sheet)
PEAK_BF16_OPS_PER_S = 989e12
LM_ARCH = "qwen2.5-3b"
LM_SERVE = dict(batch=4, prompt=128, max_new=32, reps=7)
# (b): teacher-forced prefill + decode against the full-sequence pass; the
# reference's own bar (tests/test_models.py) at reduced width
LM_FORCED = dict(batch=2, length=64, decode=2)
LM_F32_TOL = 3e-4
# (a): the same in bfloat16 on the serving prompts and 4 forced tokens.
# The bar lies between the largest sound reading on the card at prompts
# 8-128 (1.13e-2, max |logit| 0.54-0.62) and the smallest planted-fault
# reading at prompt 128 (2.54e-2: every step one position late); a decode
# that skips its cache write read 5.3e-2-5.7e-2 there (NVIDIA H100 80GB
# HBM3, 700 W).  Every run reads both faults again and holds them above it.
LM_BF16_FORCED = dict(decode=4)
LM_BF16_TOL = 2e-2
# (c): launch/serve.py's requests; (d): card against CPU, float32
LM_REQUESTS = dict(n=6, prompt=32, max_new=8, batch=4)
LM_CPU_TOL = 1e-4
LM_CPU = dict(batch=2, length=24, prompt=16)
LM_OTHERS = [("phi-3-vision-4.2b", dict(batch=2, prompt=300, max_new=8, reps=3)),
             ("whisper-base", dict(batch=2, prompt=32, max_new=8, reps=3))]
LM_CLI_ARGS = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "4",
               "--prompt-len", "32", "--max-new", "16"]


def _lm_extras(cfg, batch, rng):
    if cfg.frontend == "audio_stub":
        return {"frames": rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)
                                     ).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return {"patch_embeds": rng.normal(
            size=(batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    return None


def _event_ms(fn):
    """(result, device ms, host ms) of one call: the device's between two
    CUDA events, the host's the call's own time on its clock (issuing the
    work; the call does not wait for the card)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = fn()
    host = (time.perf_counter() - t0) * 1e3
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop), host


def _lm_bounds(model, batch, prompt, slots):
    """Least times of a prefill and of a decode step as this model computes
    them, each the larger of its bytes at 3.35 TB/s (every weight the pass
    uses read once, the KV caches read once) and its matmul operations at
    the bf16 peak (2 a multiply-add; attention scores and values over the
    full S x S, or the cache's slots, as computed).  Whisper's encoder and
    cross-attention keys run in the prefill only, over its frames; the
    vision stub's projection over its patch tokens."""
    cfg = model.cfg
    mats = {n: (p.numel(), p.element_size()) for n, p in model.named_parameters()}
    size = model.embed.element_size()

    def count(pred):
        return sum(n for name, (n, _) in mats.items() if pred(name))

    def nbytes(pred):
        return sum(n * s for name, (n, s) in mats.items() if pred(name))

    enc = count(lambda n: n.startswith("encoder.") and len(model.get_parameter(n).shape) >= 2)
    cross_kv = count(lambda n: ".cross.wk" in n or ".cross.wv" in n)
    patch = count(lambda n: n == "patch_proj")
    head = cfg.padded_vocab * cfg.d_model
    body = count(lambda n: len(model.get_parameter(n).shape) >= 2) \
        - enc - cross_kv - patch - mats["embed"][0] - mats.get("lm_head", (0, 0))[0]
    attn = 4 * cfg.num_layers * cfg.num_heads * cfg.hd  # scores + values, a key
    E = cfg.encoder_seq
    pre_ops = (2 * batch * prompt * body + 2 * batch * head
               + attn * batch * prompt * (prompt + E)
               + 2 * batch * E * (enc + cross_kv)
               + 4 * cfg.encoder_layers * cfg.num_heads * cfg.hd * batch * E * E
               + 2 * batch * min(cfg.frontend_tokens, prompt) * patch)
    dec_ops = 2 * batch * (body + head) + attn * batch * (slots + E)
    all_bytes = nbytes(lambda n: True)
    # a decode step reads the decoder's weights (the embedding's B rows
    # unless it is also the head) and the caches
    dec_bytes = (nbytes(lambda n: not n.startswith("encoder.")
                        and n != "patch_proj" and ".cross.wk" not in n
                        and ".cross.wv" not in n)
                 - (0 if cfg.tie_embeddings else mats["embed"][0] * size)
                 + cfg.num_layers * batch * size
                 * (2 * slots * cfg.num_kv_heads + 2 * E * cfg.num_heads) * cfg.hd)
    return (max(all_bytes / PEAK_BYTES_PER_S, pre_ops / PEAK_BF16_OPS_PER_S) * 1e3,
            max(dec_bytes / PEAK_BYTES_PER_S, dec_ops / PEAK_BF16_OPS_PER_S) * 1e3,
            all_bytes, pre_ops)


def _time_serving(dev, engine, prompts, max_new, reps):
    """Prefill ms (median of ``reps`` calls) and decode ms a step (median
    over one generation's steps), CUDA events, with every call's device
    and host ms; every logit finite."""
    max_len = prompts.shape[1] + max_new
    pre, pre_host = [], []
    for _ in range(reps):
        (logits, _), ms, host = _event_ms(lambda: engine.prefill(prompts, max_len))
        pre.append(ms)
        pre_host.append(host)
    assert bool(torch.isfinite(logits).all())
    logits, cache = engine.prefill(prompts, max_len)
    dec, dec_host = [], []
    for _ in range(max_new):
        tok = logits.argmax(-1, keepdim=True)
        (logits, cache), ms, host = _event_ms(lambda: engine.decode(tok, cache))
        dec.append(ms)
        dec_host.append(host)
        assert bool(torch.isfinite(logits).all())
    torch.cuda.synchronize(dev)
    return dict(prefill_ms=statistics.median(pre), prefill_ms_all=pre,
                prefill_host_ms_all=pre_host,
                decode_ms=statistics.median(dec), decode_ms_all=dec,
                decode_host_ms=statistics.median(dec_host),
                decode_host_ms_all=dec_host)


def _teacher_forced(model, cfg, tokens, P, fault=None):
    """Prefill over ``tokens[:, :P]`` and one decode step a later token,
    against ``forward_train`` over all of ``tokens`` at the same positions:
    (largest |difference|, argmax equal, largest |logit|, smallest top-2
    gap).  ``fault`` plants a known defect, for the reading a bar must
    catch: "skip_write" zeroes what each step wrote into its cache after
    the step (a decode that never wrote its cache), "position" runs every
    step one position late; for the MoE and MLA families "skip_shared"
    leaves out the shared experts in the prefill and the steps, and
    "krope_late" moves the prefill's rotated MLA keys one slot later (a
    cache fill one slot late).  The faults are planted on this model
    instance by the script; the package is not changed."""
    from repro_torch.models import (forward_decode, forward_prefill,
                                    forward_train)

    S = tokens.shape[1]
    shared = [layer.ffn.shared for layer in model.layers
              if layer.moe and hasattr(layer.ffn, "shared")]
    assert fault != "skip_shared" or shared, "no shared experts to skip"
    with torch.inference_mode():
        want = forward_train(model, tokens, cfg)[0][:, P - 1:]
        if fault == "skip_shared":
            for m in shared:
                m.forward = torch.zeros_like
        try:
            logits, cache = forward_prefill(model, tokens[:, :P], cfg, max_len=S + 1)
            if fault == "position":
                cache["pos"] += 1
            if fault == "krope_late":
                for lay in cache["layers"]:
                    lay["krope"][:, 1:P + 1] = lay["krope"][:, :P].clone()
                    lay["krope"][:, 0] = 0
            steps = [logits]
            for t in range(P, S):
                logits, cache = forward_decode(model, tokens[:, t:t + 1], cache, cfg)
                if fault == "skip_write":
                    for lay in cache["layers"]:
                        for buf in lay.values():
                            buf[:, cache["pos"] - 1] = 0
                steps.append(logits)
        finally:
            for m in shared:
                m.__dict__.pop("forward", None)
        steps = torch.stack(steps, 1)
        top2 = want.topk(2, dim=-1).values
        return ((steps - want).abs().max().item(),
                bool(torch.equal(steps.argmax(-1), want.argmax(-1))),
                want.abs().max().item(),
                (top2[..., 0] - top2[..., 1]).min().item())


def drive_lm_serve(dev, card):
    """Phase 17 (a): qwen2.5-3b at full width in bfloat16 on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    cfg = get_config(LM_ARCH)
    B, S, new = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["max_new"]
    rng = np.random.default_rng(SEED)
    torch.zeros(1, device=dev)       # the allocator exists before its reset
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # what earlier phases still hold (plans, schedules) is not this path's
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, device=dev)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    walls, outs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(engine.generate_batch(prompts, new))
        walls.append(time.perf_counter() - t0)
    assert outs[0].shape == (B, new) and outs[0].dtype == np.int32
    assert np.array_equal(outs[0], outs[1]), "a second call gave other tokens"
    assert ((outs[0] >= 0) & (outs[0] < cfg.padded_vocab)).all()
    times = _time_serving(dev, engine, prompts, new, LM_SERVE["reps"])
    pre_ms, dec_ms = times["prefill_ms"], times["decode_ms"]
    peak = torch.cuda.max_memory_allocated(dev) - base
    # bfloat16 prefill + decode against the bfloat16 full-sequence pass on
    # the serving prompts and a few forced tokens, then with planted faults
    D = LM_BF16_FORCED["decode"]
    forced_tokens = np.concatenate(
        [prompts, rng.integers(0, cfg.vocab_size, size=(B, D)).astype(np.int32)], 1)
    forced = {fault or "sound": _teacher_forced(model, cfg, forced_tokens, S, fault)[0]
              for fault in (None, "skip_write", "position")}
    assert forced["sound"] < LM_BF16_TOL, (forced, LM_BF16_TOL)
    assert min(forced["skip_write"], forced["position"]) > LM_BF16_TOL, \
        ("the bar no longer catches a planted fault", forced, LM_BF16_TOL)
    pre_bound, dec_bound, weight_bytes, pre_ops = _lm_bounds(model, B, S, S + new)
    # one prefill and one decode step under the profiler: device kernels
    # and busy time (a repeated step rewrites the same cache slot)
    logits, cache = engine.prefill(prompts, S + new)
    tok = logits.argmax(-1, keepdim=True)
    prof_pre = _profile(dev, lambda: engine.prefill(prompts, S + new))
    prof_dec = _profile(dev, lambda: engine.decode(tok, cache))
    del logits, cache
    for prof, ms in ((prof_pre, pre_ms), (prof_dec, dec_ms)):
        prof.pop("dense_lu_kernels", None)
        prof.pop("level_run_kernels", None)
        if "device_busy_ms" in prof:
            prof["busy_share"] = prof["device_busy_ms"] / ms
    report = dict(
        arch=cfg.name, dtype=cfg.dtype, params=cfg.param_count(), batch=B,
        prompt=S, max_new=new, card=card, init_s=init_s,
        generate_s=walls, tokens_per_s=B * new / walls[1], **times,
        prefill_bound_ms=pre_bound, prefill_tflop=pre_ops / 1e12,
        decode_bound_ms=dec_bound, bf16_forced=dict(
            prompt=S, decode_steps=D, max_abs_err=forced, tol=LM_BF16_TOL),
        prefill_profile=prof_pre, decode_profile=prof_dec,
        weight_gb=weight_bytes / 1e9, peak_mib=peak / 2**20,
        held_before_mib=base / 2**20,
        sample=outs[0][0, :16].tolist(), clock="CUDA events (ms), host (s)")
    log(f"serve {cfg.name} bf16 B={B} prompt {S} +{new}: prefill "
        f"{pre_ms:.3f} ms (bound {pre_bound:.3f}, {pre_ops / 1e12:.2f} TFLOP), "
        f"decode {dec_ms:.3f} ms a step (bound {dec_bound:.3f}, "
        f"{weight_bytes / 1e9:.2f} GB of weights; host {times['decode_host_ms']:.3f} "
        f"ms a step, {min(times['decode_ms_all']):.3f}-"
        f"{max(times['decode_ms_all']):.3f} ms over the steps), {B * new / walls[1]:.1f} "
        f"tok/s (generate {walls[0]:.2f} / {walls[1]:.2f} s), peak "
        f"{peak / 2**20:.1f} MiB over the {base / 2**20:.1f} MiB held before, "
        f"init {init_s:.2f} s [{card}]")
    for what, prof in (("prefill", prof_pre), ("decode step", prof_dec)):
        log(f"  one {what}: {prof.get('kernels', 'not measured')} device "
            f"kernels, busy {prof.get('device_busy_ms', 'not measured')} ms "
            f"(share {prof.get('busy_share', 'not measured')})")
    log(f"  bf16 prefill {S} + {D} decode steps against forward_train: "
        + ", ".join(f"{k} {v:.3e}" for k, v in forced.items())
        + f" (bar {LM_BF16_TOL})")
    return report, engine


def drive_lm_forced(dev):
    """Phase 17 (b): float32 at full width with TF32 off, prefill + decode
    against the full-sequence pass."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    B, S, D = LM_FORCED["batch"], LM_FORCED["length"], LM_FORCED["decode"]
    P = S - D
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    tokens = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    err, same, scale, gap = _teacher_forced(model, cfg, tokens, P)
    assert err < LM_F32_TOL, (err, LM_F32_TOL)
    assert same, "float32 prefill/decode argmax differs from forward_train"
    del model
    torch.cuda.empty_cache()
    log(f"serve {cfg.name} float32 (TF32 off): prefill {P} + {D} decode steps "
        f"within {err:.3e} of forward_train (bar {LM_F32_TOL}; max |logit| "
        f"{scale:.3f}, smallest top-2 gap {gap:.3e})")
    return dict(arch=cfg.name, dtype="float32", tf32=False, batch=B, prompt=P,
                decode_steps=D, max_abs_err=err, tol=LM_F32_TOL,
                max_abs_logit=scale, min_top2_gap=gap)


def drive_lm_requests(engine):
    """Phase 17 (c): ``ServeEngine.run`` on launch/serve.py's requests."""
    from repro_torch.serving import Request

    cfg = engine.cfg
    rng = np.random.default_rng(SEED + 2)
    n, new = LM_REQUESTS["n"], LM_REQUESTS["max_new"]
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size,
                                               size=LM_REQUESTS["prompt"]).astype(np.int32),
                    max_new=new, parent=i - 1 if i % 3 == 2 else None)
            for i in range(n)]
    calls = []
    plain = engine.generate_batch

    def recording(prompts, max_new):
        out = plain(prompts, max_new)
        calls.append((prompts.copy(), out))
        return out

    engine.generate_batch = recording
    t0 = time.perf_counter()
    try:
        results = engine.run(reqs, batch_size=LM_REQUESTS["batch"])
    finally:
        del engine.generate_batch
    wall = time.perf_counter() - t0
    assert sorted(results) == list(range(n))
    assert all(len(r.tokens) == LM_REQUESTS["prompt"] for r in reqs)
    eff = {}
    for r in reqs:
        eff[r.rid] = (r.tokens if r.parent is None else
                      np.concatenate([eff[r.parent], results[r.parent], r.tokens]))
    served, alone = {}, 0
    for k, (prompts, out) in enumerate(calls):
        # every row the engine served is one request's spliced prompt,
        # built here from the requests and the parents' results
        rids = [[i for i, e in eff.items() if np.array_equal(e, row)]
                for row in prompts]
        assert all(len(r) == 1 for r in rids), ("a served row is no request's "
                                                "spliced prompt", k)
        rids = [r[0] for r in rids]
        # each row against the same group of spliced prompts generated again
        again = plain(np.stack([eff[i] for i in rids]), new)
        for rid, o, a in zip(rids, out, again):
            served[rid] = k
            assert np.array_equal(o, results[rid]) and np.array_equal(a, o), rid
            alone += int(np.array_equal(plain(eff[rid][None], new)[0], o))
    assert sorted(served) == list(range(n))
    for r in reqs:
        if r.parent is not None:
            assert served[r.rid] > served[r.parent], (r.rid, r.parent)
    distinct = len(np.unique(np.concatenate([results[i] for i in results])))
    log(f"serve run: {n} requests in {len(calls)} batches ({wall:.2f} s), "
        f"children after parents, every served row a spliced prompt, outputs "
        f"equal to their groups' spliced prompts; {alone} of {n} rows equal "
        f"to their prompt alone; {distinct} distinct output tokens")
    return dict(n=n, batches=[len(c[0]) for c in calls], wall_s=wall,
                rows_equal_alone=alone, distinct_tokens=distinct, clock="host")


def drive_lm_cpu_card(dev, cfg=None, spec=LM_CPU):
    """Phase 17 (d), 18 (d), 19 (d): a reduced config (by default qwen's),
    the same float32 parameters on the card and on the CPU; for MoE configs
    the assignments each side dropped at capacity in the prefill, equal.
    ``spec`` gives the batch, the tokens, the prompt and (``train``, all
    tokens by default) how many of them ``forward_train`` reads."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays
    from repro_torch.models import (forward_decode, forward_prefill,
                                    forward_train, init_params)
    from repro_torch.serving import ServeEngine

    cfg = cfg or get_config(LM_ARCH).reduced()
    assert cfg.dtype == "float32" and not torch.backends.cuda.matmul.allow_tf32
    B, S, P = spec["batch"], spec["length"], spec["prompt"]
    T = spec.get("train", S)
    host = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    card = lm_params_from_arrays(cfg, lm_params_to_arrays(host), device=dev)
    tokens = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    def run(model):
        with torch.inference_mode():
            full, aux = forward_train(model, tokens[:, :T], cfg)
            logits, cache = forward_prefill(model, tokens[:, :P], cfg, max_len=S)
            dropped = moe_dropped(model)
            steps = [logits]
            for t in range(P, S):
                logits, cache = forward_decode(model, tokens[:, t:t + 1], cache, cfg)
                steps.append(logits)
            return full.cpu(), torch.stack(steps, 1).cpu(), aux.item(), dropped

    (f_h, s_h, aux_h, drop_h), (f_c, s_c, aux_c, drop_c) = run(host), run(card)
    err = max((f_h - f_c).abs().max().item(), (s_h - s_c).abs().max().item())
    assert err < LM_CPU_TOL, (err, LM_CPU_TOL)
    assert torch.equal(s_h.argmax(-1), s_c.argmax(-1))
    assert drop_h == drop_c, (drop_h, drop_c)
    assert abs(aux_h - aux_c) < 1e-5, (aux_h, aux_c)
    gen_h = ServeEngine(cfg, host, device="cpu").generate_batch(tokens[:, :P], S - P)
    gen_c = ServeEngine(cfg, card, device=dev).generate_batch(tokens[:, :P], S - P)
    assert np.array_equal(gen_h, gen_c), (gen_h, gen_c)
    moe = (f" (capacity factor {cfg.capacity_factor:g}: aux {aux_c:.6f} / "
           f"{aux_h:.6f}, prefill dropped {drop_c} / {drop_h} assignments)"
           if cfg.n_experts else "")
    log(f"serve {cfg.name} reduced float32, train {T}, prompt {P} +{S - P}"
        f"{moe}: card within {err:.3e} of the CPU (bar {LM_CPU_TOL}), the "
        f"same {gen_c.size} greedy tokens")
    return dict(arch=cfg.name, reduced=True, train=T, prompt=P, length=S,
                capacity_factor=cfg.capacity_factor,
                max_abs_err=err, tol=LM_CPU_TOL, aux=aux_c, aux_cpu=aux_h,
                prefill_dropped=drop_c, tokens_equal=True)


def drive_lm_others(dev, card):
    """Phase 17 (e): phi-3-vision-4.2b and whisper-base at full width."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    reports = []
    for arch, spec in LM_OTHERS:
        cfg = get_config(arch)
        B, S, new = spec["batch"], spec["prompt"], spec["max_new"]
        rng = np.random.default_rng(SEED + 4)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        engine = ServeEngine(cfg, model, _lm_extras(cfg, B, rng), device=dev)
        prompts = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
        t0 = time.perf_counter()
        out = engine.generate_batch(prompts, new)
        wall = time.perf_counter() - t0
        assert out.shape == (B, new)
        times = _time_serving(dev, engine, prompts, new, spec["reps"])
        pre_ms, dec_ms = times["prefill_ms"], times["decode_ms"]
        pre_bound, dec_bound, weight_bytes, _ = _lm_bounds(model, B, S, S + new)
        log(f"serve {cfg.name} bf16 B={B} prompt {S} +{new}: prefill "
            f"{pre_ms:.3f} ms (bound {pre_bound:.3f}), decode {dec_ms:.3f} ms "
            f"a step (bound {dec_bound:.3f}), logits finite, first generate "
            f"{wall:.2f} s [{card}]")
        reports.append(dict(arch=cfg.name, dtype=cfg.dtype, params=cfg.param_count(),
                            batch=B, prompt=S, max_new=new, prefill_ms=pre_ms,
                            prefill_bound_ms=pre_bound, decode_ms=dec_ms,
                            decode_bound_ms=dec_bound, first_generate_s=wall,
                            extras=sorted(engine.extras or {})))
        del model, engine
        torch.cuda.empty_cache()
    return reports


def drive_serve_cli(args, result):
    """Phase 17 (f), 18 (f), 19 (f): ``python -m repro_torch.launch.serve
    ARGS`` in a subprocess on the card (``result`` of
    :func:`run_at_once`): exit 0 and the reference's two lines."""
    rc, stdout, stderr, wall = result
    assert rc == 0, (rc, stderr[-2000:])
    lines = stdout.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("generated (4, 16)") \
        and lines[1].startswith("sample: ["), lines
    log(f"serve cli: -m repro_torch.launch.serve {' '.join(args)} -> exit 0 in "
        f"{wall:.1f} s: {lines[0]} | {lines[1]}")
    return dict(args=list(args), lines=lines, wall_s=wall, clock="host")


# -- phase 18: MLA attention and the sort-based MoE -----------------------------
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_SERVE = dict(batch=4, prompt=128, max_new=32, reps=5)
# (b): bf16 prefill + 4 decode steps on the served prompts against bf16
# forward_train, dropless (capacity factor E / K, the reduced configs' own
# rule: the published 1.25 drops other assignments in a 132-token pass
# than in a 128-token prefill).  At full depth bf16 routing flips make the
# sound reading large: 0.35-1.48 of logits up to 4.75 on the card, prompts
# 8-128, 2 and 4 steps, 2 seeds, where the planted faults read at least
# 5.31 (shared experts skipped) and 3.30 (krope one slot late), but a
# position late only 1.50-2.12 (tools/moe_forced_readings.py, NVIDIA H100
# 80GB HBM3, 700 W).  The bar lies between; it catches gross faults only,
# and (c) holds the same path in float32 to the reference's bar.
MOE_BF16_FORCED = dict(decode=4)
MOE_BF16_TOL = 2.5
MOE_BF16_FAULTS = ("skip_shared", "krope_late")
# (c): float32 at full width and depth (62.8 GB of weights), TF32 off,
# dropless, at the reference's bar, every planted fault above it
MOE_F32 = dict(batch=2, length=64, decode=2)
MOE_F32_FAULTS = ("skip_shared", "krope_late", "position")
# (d): reduced configs, card against CPU; the last one drops assignments
MOE_CPU = [("deepseek-v2-lite-16b", {}), ("mixtral-8x7b", {}),
           ("deepseek-v2-lite-16b", {"capacity_factor": 0.25, "moe_groups": 0})]
# (e): mixtral-8x7b at full width, 8 of its 32 layers (the 32 take 93.4 GB
# in bf16, more than one 80 GB card)
MIXTRAL = dict(arch="mixtral-8x7b", layers=8, batch=4, prompt=128, max_new=8,
               reps=3)
MOE_CLI_ARGS = ["--arch", "deepseek-v2-lite-16b", "--reduced", "--batch", "4",
                "--prompt-len", "32", "--max-new", "16"]


def moe_dropped(model) -> int:
    """Assignments the model's MoE layers dropped at capacity in its last
    call (0 without MoE layers)."""
    return sum(int(layer.ffn.dropped) for layer in model.layers if layer.moe)


def _expert_hits(model, fn):
    """(fn's result, distinct experts each MoE layer's router chose during
    ``fn()``), read from the layers' inputs by forward hooks."""
    hits, hooks = [], []

    def hook(moe, args):
        x = args[0]
        top = torch.topk(x.reshape(-1, x.shape[-1]).float() @ moe.router,
                         moe.cfg.top_k, dim=-1).indices
        hits.append(int(torch.unique(top).numel()))

    for layer in model.layers:
        if layer.moe:
            hooks.append(layer.ffn.register_forward_pre_hook(hook))
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    return out, hits


def _mamba_ops(cfg, batch, n_tok, S):
    """(bf16 matmul operations, float32 operations) of one Mamba-2 layer
    over ``n_tok`` tokens of ``S`` positions a row: the two projections
    (and the conv taps) in the weights' dtype; in float32 the chunked
    scan's four contractions over chunks of ``min(128, S)`` (its diagonal
    blocks as computed, the full Q x Q) or, for one decode step, the
    state update and read-out."""
    d, P, N = cfg.d_model, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.ssm_expand * d
    H = di // P
    mm = 2 * n_tok * d * (2 * di + 2 * N + H) + 2 * n_tok * di * d \
        + 2 * n_tok * cfg.ssm_conv * (di + 2 * N)
    if S == 1:
        return mm, 4 * batch * H * P * N
    Q = min(128, S)
    return mm, (2 * n_tok * Q * N + 2 * n_tok * Q * H * P
                + 4 * n_tok * H * P * N)


def _model_bounds(model, batch, prompt, slots, hits):
    """Least times of a prefill and of a decode step of an MLA / MoE /
    Mamba-2 model as it computes them.  Operations: the matmuls at the
    bf16 peak (2 a multiply-add), MoE experts over every capacity slot of
    every group (E * cap rows an expert, as dispatched), MLA's k_nope and v
    recomputed over all the cache's slots, scores and values over the keys
    computed; the Mamba-2 scan's float32 contractions at the float32 peak
    (``_mamba_ops``).  Bytes at 3.35 TB/s, two ways: every weight read
    once (the capacity dispatch reads every expert, so it is the path's
    own), and only the weights the step used (the experts its routers
    chose, ``hits`` per MoE layer); a decode step reads the attention
    caches once and reads and writes the Mamba states and conv
    histories."""
    from repro_torch.models import cache_specs
    from repro_torch.models.layers import MLAttention, moe_capacity

    cfg = model.cfg
    d, size = cfg.d_model, model.embed.element_size()
    gated = 3 if cfg.act in ("swiglu", "geglu") else 2

    def layer_ops(layer, n_tok, sq, sk):
        """(operations at the bf16 peak, float32 operations)."""
        B = batch
        if hasattr(layer, "mamba"):
            ops, f32 = _mamba_ops(cfg, B, n_tok, sq)
            return ops + _ffn_ops(layer, n_tok), f32
        a = layer.attn
        if isinstance(a, MLAttention):
            H, r, dn, dr, dv = (cfg.num_heads, cfg.kv_lora_rank,
                                cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                                cfg.v_head_dim)
            ops = (2 * n_tok * d * (H * (dn + dr) + r + dr + H * dv)
                   + 2 * B * sk * r * H * (dn + dv)
                   + 2 * B * H * sq * sk * (dn + dr + dv))
        else:
            H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
            ops = 2 * n_tok * d * (2 * H + 2 * KV) * hd + 4 * B * H * sq * sk * hd
        return ops + _ffn_ops(layer, n_tok), 0

    def _ffn_ops(layer, n_tok):
        if layer.moe:
            G, cap = moe_capacity(cfg, n_tok)
            f = cfg.moe_d_ff or cfg.d_ff
            ops = 2 * n_tok * d * cfg.n_experts + 2 * gated * G * cfg.n_experts * cap * d * f
            if cfg.n_shared_experts:
                ops += 2 * gated * n_tok * d * cfg.n_shared_experts * f
            return ops
        return 2 * gated * n_tok * d * cfg.d_ff if hasattr(layer, "ffn") else 0

    def total(n_tok, sq, sk):
        ops = [layer_ops(lay, n_tok, sq, sk) for lay in model.layers]
        return 2 * batch * d * cfg.padded_vocab + sum(o for o, _ in ops), sum(f for _, f in ops)

    (pre_ops, pre_f32), (dec_ops, dec_f32) = (total(batch * prompt, prompt, prompt),
                                              total(batch, 1, slots))
    weights = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                  if n != "embed") + batch * d * size
    expert = {n: p[0].numel() * p.element_size()
              for n, p in model.named_parameters() if ".experts." in n}
    unused = 0
    moe_layers = [i for i, lay in enumerate(model.layers) if lay.moe]
    assert len(hits) == len(moe_layers), (len(hits), len(moe_layers))
    for i, h in zip(moe_layers, hits):
        per = sum(v for n, v in expert.items() if n.startswith(f"layers.{i}."))
        unused += (cfg.n_experts - h) * per
    # attention buffers are read once; a Mamba layer's state and conv
    # history are read and written
    cache = sum(math.prod(shape) * (4 if dt == "float32" else 2)
                * (1 if cfg.is_attn_layer(i) else 2)
                for i, layer in enumerate(cache_specs(cfg, batch, slots)["layers"])
                for shape, dt in layer.values())
    dec_all = weights + cache
    dec_active = weights - unused + cache

    def ms(b, o, f32):
        return max(b / PEAK_BYTES_PER_S,
                   o / PEAK_BF16_OPS_PER_S + f32 / PEAK_OPS_PER_S["float32"]) * 1e3

    out = dict(prefill_bound_ms=ms(weights, pre_ops, pre_f32),
               prefill_tflop=pre_ops / 1e12,
               decode_bound_ms=ms(dec_all, dec_ops, dec_f32),
               decode_bound_active_ms=ms(dec_active, dec_ops, dec_f32),
               decode_gflop=dec_ops / 1e9, weight_gb=weights / 1e9,
               decode_active_gb=dec_active / 1e9, cache_gb=cache / 1e9)
    if pre_f32:
        out.update(prefill_f32_tflop=pre_f32 / 1e12, decode_f32_gflop=dec_f32 / 1e9)
    return out


def drive_moe_serve(dev, card):
    """Phase 18 (a): deepseek-v2-lite-16b at full width and depth in
    bfloat16, the published capacity factor."""
    from repro_torch.configs import get_config

    report, model, engine, prompts = _serve_phase(dev, get_config(MOE_ARCH),
                                                  MOE_SERVE, SEED + 5)
    _log_serve(report, card)
    del model, engine
    torch.cuda.empty_cache()
    return report, prompts


def drive_moe_forced(dev, prompts):
    """Phase 18 (b): bf16 prefill + decode against bf16 ``forward_train``
    on (a)'s prompts, dropless, sound and with each planted fault."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, capacity_factor=base.n_experts / base.top_k)
    B, S = prompts.shape
    D = MOE_BF16_FORCED["decode"]
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED + 6)
    tokens = np.concatenate(
        [prompts, rng.integers(0, cfg.vocab_size, size=(B, D)).astype(np.int32)], 1)
    from repro_torch.models import forward_prefill, forward_train

    with torch.inference_mode():
        forward_train(model, tokens, cfg)
        train_dropped = moe_dropped(model)
        forward_prefill(model, tokens[:, :S], cfg)
        assert train_dropped == moe_dropped(model) == 0, "the dropless capacity dropped"
    readings = {}
    for fault in (None, *MOE_BF16_FAULTS, "position"):
        err, same, scale, gap = _teacher_forced(model, cfg, tokens, S, fault)
        readings[fault or "sound"] = err
        if fault is None:
            sound = dict(argmax_equal=same, max_abs_logit=scale, min_top2_gap=gap)
    del model
    torch.cuda.empty_cache()
    assert readings["sound"] < MOE_BF16_TOL, (readings, MOE_BF16_TOL)
    assert min(readings[f] for f in MOE_BF16_FAULTS) > MOE_BF16_TOL, \
        ("the bar no longer catches a planted fault", readings, MOE_BF16_TOL)
    log(f"  bf16 prefill {S} + {D} decode steps against forward_train "
        f"(capacity factor {cfg.capacity_factor:.4g}, dropless): "
        + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
        + f" (bar {MOE_BF16_TOL}; max |logit| {sound['max_abs_logit']:.3f}, "
        f"argmax equal {sound['argmax_equal']})")
    return dict(prompt=S, decode_steps=D, capacity_factor=cfg.capacity_factor,
                max_abs_err=readings, tol=MOE_BF16_TOL, **sound)


def drive_moe_f32(dev):
    """Phase 18 (c): float32 at full width and depth, TF32 off, dropless,
    against the full-sequence pass at the reference's bar, sound and with
    each planted fault."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    assert not torch.backends.cuda.matmul.allow_tf32
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, dtype="float32",
                              capacity_factor=base.n_experts / base.top_k)
    B, S, D = MOE_F32["batch"], MOE_F32["length"], MOE_F32["decode"]
    torch.cuda.empty_cache()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    tokens = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    err, same, scale, gap = _teacher_forced(model, cfg, tokens, S - D)
    faults = {f: _teacher_forced(model, cfg, tokens, S - D, f)[0]
              for f in MOE_F32_FAULTS}
    del model
    torch.cuda.empty_cache()
    assert err < LM_F32_TOL, (err, LM_F32_TOL)
    assert same, "float32 prefill/decode argmax differs from forward_train"
    assert min(faults.values()) > LM_F32_TOL, ("a planted fault passes", faults)
    log(f"serve {cfg.name} float32 (TF32 off, {cfg.num_layers} layers, dropless): "
        f"prefill {S - D} + {D} decode steps within {err:.3e} of forward_train "
        f"(bar {LM_F32_TOL}; max |logit| {scale:.3f}, smallest top-2 gap {gap:.3e}); "
        + ", ".join(f"{k} {v:.3e}" for k, v in faults.items()))
    return dict(arch=cfg.name, dtype="float32", layers=cfg.num_layers, tf32=False,
                batch=B, prompt=S - D, decode_steps=D, max_abs_err=err,
                tol=LM_F32_TOL, max_abs_logit=scale, min_top2_gap=gap,
                faults=faults)


def drive_moe_cpu_card(dev):
    """Phase 18 (d): reduced deepseek and mixtral, card against CPU; one
    variant drops assignments at capacity, on both."""
    import dataclasses

    from repro_torch.configs import get_config

    out = []
    for arch, overrides in MOE_CPU:
        cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
        out.append(drive_lm_cpu_card(dev, cfg))
    assert out[-1]["prefill_dropped"] > 0, out[-1]
    assert all(r["prefill_dropped"] == 0 for r in out[:-1]), out
    return out


def drive_mixtral(dev, card):
    """Phase 18 (e): mixtral-8x7b at full width and 8 of its 32 layers,
    bf16, the published capacity factor."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MIXTRAL["arch"]), num_layers=MIXTRAL["layers"])
    report, model, engine, _ = _serve_phase(dev, cfg, MIXTRAL, SEED + 8)
    _log_serve(report, card)
    del model, engine
    torch.cuda.empty_cache()
    return report

# -- phase 19: the Mamba-2 (SSD) block and its state cache ---------------------
SSM_ARCH = "mamba2-2.7b"
# (a)-(c) run 32 of its 64 layers, cut for the script's time limit: the
# decode steps of (b) and (c) are host-bound, about 1.4 ms a layer
SSM_LAYERS = 32
# (a): a prompt of 8 chunks of 128, so the inter-chunk recurrence runs
SSM_SERVE = dict(batch=4, prompt=1024, max_new=32, reps=3)
# (b): float32 at (a)'s width and depth, TF32 off: prefill + teacher-forced
# decode steps against forward_train over all of them (1,152 tokens: 9
# chunks; a pass over more than 128 tokens must be whole chunks), at the
# reference's bar, with four planted faults above it
SSM_F32 = dict(batch=2, prompt=1024, decode=128)
SSM_FAULTS = ("chunk_state", "skip_decay", "conv_late", "skip_D")
# a fault run compares the prefill's last position and this many decode
# steps (every fault shows from the first step: "chunk_state" where
# forward_train's ninth chunk begins, at the first decode position)
SSM_FAULT_STEPS = 8
# (c): (a)'s bf16 weights and prompts, 128 forced steps, against bf16
# forward_train.  At full depth bf16 noise makes the sound reading
# 0.18-0.31 on logits up to 6.0 (12 readings on the card, prompts 32-1024,
# 4 and 128 steps, 2 seeds; top-2 logit gaps of 0), and "chunk_state"
# reads no more than that (0.19-0.29): bf16 does not separate it, and
# (b) holds it in float32.  With 128 steps the other faults read at least
# 2.18 (skip_decay), 6.83 (conv_late) and 6.83 (skip_D)
# (tools/ssm_forced_readings.py, NVIDIA H100 80GB HBM3, 700 W).  At 32
# layers, on (a)'s prompts: sound 0.19, skip_decay 1.52, conv_late 6.86,
# skip_D 8.52 (the same card).  The bar lies between.
SSM_BF16_FORCED = dict(decode=128)
SSM_BF16_TOL = 1.0
SSM_BF16_FAULTS = ("skip_decay", "conv_late", "skip_D")
# (d): reduced configs, card against CPU; forward_train and the prefill
# read two chunks of 128, so the card's state carried into the second
# chunk (which the seeded decays keep only a few steps) is read at its
# first positions and by the 8 decode steps after the prefill
SSM_CPU = ("mamba2-2.7b", "jamba-v0.1-52b")
SSM_CPU_LEN = dict(batch=2, length=264, prompt=256, train=256)
# and the scan alone at mamba2's heads (80 of 64 x 128) over two chunks,
# float32 on the card against the float64 per-step recurrence on the host,
# from unit-scale inputs (silu of normals, softplus steps, A in
# -exp([-1, 1])) and a random initial state, where the carry into a chunk
# matters; |difference| over max |y| (and over max |h| for the final
# state).  On the CPU these read 3.1e-6 for y and 1.8e-5 for the state
# (the float32 cumsum of dt A over a chunk reaches about -350, and the
# decays from its differences lose their last bits), and 0.37 with each
# chunk reading its own end state.
SSD_SCAN = dict(batch=2, length=256)
SSD_SCAN_TOL = 1e-4
# (e): jamba-v0.1-52b at full width, 8 of its 32 layers (one period of
# its pattern; the 32 take 103 GB in bf16, more than one 80 GB card)
JAMBA = dict(arch="jamba-v0.1-52b", layers=8, batch=4, prompt=1024,
             max_new=32, reps=3)
JAMBA_F32 = dict(batch=2, prompt=256, decode=128)
SSM_CLI_ARGS = [["--arch", arch, "--reduced", "--batch", "4", "--prompt-len",
                 "32", "--max-new", "16"] for arch in SSM_CPU]


def _mamba_caches(cache):
    return [lay for lay in cache["layers"] if "h" in lay]


def _own_end_states(plain):
    """The "chunk_state" fault of ``chunk_states``: each chunk reads its
    own end state where it should read the state before it."""
    def states(sb, seg_total, h0=None):
        prevs, h = plain(sb, seg_total, h0)
        return torch.cat([prevs[:, 1:], h[:, None]], 1), h
    return states


def _ssm_forced(model, cfg, tokens, P, faults=(None,), fault_steps=None):
    """Prefill over ``tokens[:, :P]`` and one decode step a later token,
    against ``forward_train`` over all of ``tokens`` at the same
    positions, sound (None) and with each planted fault: {fault or
    "sound": (largest |difference|, argmax equal, largest |logit|,
    smallest top-2 gap)}.  A fault run stops after ``fault_steps`` decode
    steps when that is given (its reading then covers those positions).  The faults: "chunk_state" gives each chunk of
    the chunked scan its own end state where it should read the state
    before it, in ``forward_train`` and the prefill alike (a fault of the
    scan both run: it shows where ``forward_train``'s chunk after the
    prompt begins and the decode steps' recurrence does not share it; at
    the prefill's last position alone it would not, since the init rule's
    decays, ``exp(dt A)`` of about exp(-1) to exp(-16) a step, forget a
    state long before the next chunk ends); "skip_decay" runs the decode
    steps without the decay ``exp(dt A)``; "conv_late" moves the
    prefill's conv histories one slot later; "skip_D" drops the ``D`` skip
    in the prefill and the steps.  The script plants them on this model
    instance and on the layers module's ``chunk_states`` / ``ssd_step``
    for the call; the package is not changed."""
    import repro_torch.models.layers as L
    from repro_torch.models import (forward_decode, forward_prefill,
                                    forward_train)

    plain_states, plain_step = L.chunk_states, L.ssd_step
    own_end_state = _own_end_states(plain_states)

    def no_decay(h, dt, A, B1, C1, x1):
        return plain_step(h, dt, torch.zeros_like(A), B1, C1, x1)

    mambas = [layer.mamba for layer in model.layers if hasattr(layer, "mamba")]
    S = tokens.shape[1]
    with torch.inference_mode():
        sound = forward_train(model, tokens, cfg)[0][:, P - 1:]
    top2 = sound.topk(2, dim=-1).values
    scale = sound.abs().max().item()
    gap = (top2[..., 0] - top2[..., 1]).min().item()
    out = {}
    for fault in faults:
        saved = [m.D.clone() for m in mambas] if fault == "skip_D" else []
        want = sound
        try:
            if fault == "chunk_state":
                L.chunk_states = own_end_state
                with torch.inference_mode():
                    want = forward_train(model, tokens, cfg)[0][:, P - 1:]
            if fault == "skip_decay":
                L.ssd_step = no_decay
            with torch.no_grad():
                for m in mambas if saved else ():
                    m.D.zero_()
            with torch.inference_mode():
                logits, cache = forward_prefill(model, tokens[:, :P], cfg, max_len=S + 1)
                if fault == "conv_late":
                    for lay in _mamba_caches(cache):
                        lay["conv"][:, 1:] = lay["conv"][:, :-1].clone()
                        lay["conv"][:, 0] = 0
                steps = [logits]
                end = S if fault is None or not fault_steps else P + fault_steps
                for t in range(P, end):
                    logits, cache = forward_decode(model, tokens[:, t:t + 1], cache, cfg)
                    steps.append(logits)
                steps = torch.stack(steps, 1)
                w = want[:, :steps.shape[1]]
                out[fault or "sound"] = ((steps - w).abs().max().item(),
                                         bool(torch.equal(steps.argmax(-1),
                                                          w.argmax(-1))),
                                         scale, gap)
                del steps, cache, logits, want
        finally:
            L.chunk_states, L.ssd_step = plain_states, plain_step
            with torch.no_grad():
                for m, d in zip(mambas, saved):
                    m.D.copy_(d)
    del sound
    return out


def _profiled(dev, fn, ms):
    """One call under the profiler: device kernels, busy ms and its share
    of ``ms`` (the run's median)."""
    prof = _profile(dev, fn)
    prof.pop("dense_lu_kernels", None)
    prof.pop("level_run_kernels", None)
    if "device_busy_ms" in prof:
        prof["busy_share"] = prof["device_busy_ms"] / ms
    return prof


def _serve_phase(dev, cfg, spec, seed):
    """Init ``cfg`` from the seed on the card, ``generate_batch`` twice
    (equal tokens), the timings, the bounds, peak memory over what was
    held before, one prefill's and one decode step's profile and, for MoE
    layers, the prefill's drops and the experts each decode step's routers
    chose.  Returns (report, model, engine, prompts)."""
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    B, S, new = spec["batch"], spec["prompt"], spec["max_new"]
    rng = np.random.default_rng(seed)
    torch.zeros(1, device=dev)       # the allocator exists before its reset
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, device=dev)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    walls, outs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(engine.generate_batch(prompts, new))
        walls.append(time.perf_counter() - t0)
    assert outs[0].shape == (B, new) and outs[0].dtype == np.int32
    assert np.array_equal(outs[0], outs[1]), "a second call gave other tokens"
    assert ((outs[0] >= 0) & (outs[0] < cfg.padded_vocab)).all()
    times = _time_serving(dev, engine, prompts, new, spec["reps"])
    peak = torch.cuda.max_memory_allocated(dev) - base
    (logits, cache), pre_hits = _expert_hits(model, lambda: engine.prefill(prompts, S + new))
    dropped = moe_dropped(model)
    tok = logits.argmax(-1, keepdim=True)
    _, dec_hits = _expert_hits(model, lambda: engine.decode(tok, cache))
    # an attention layer's slots (the whole rolling buffer under SWA)
    slots = cfg.window if cfg.attention == "swa" else S + new
    bounds = _model_bounds(model, B, S, slots, dec_hits)
    prof_pre = _profiled(dev, lambda: engine.prefill(prompts, S + new),
                         times["prefill_ms"])
    prof_dec = _profiled(dev, lambda: engine.decode(tok, cache), times["decode_ms"])
    del logits, cache
    report = dict(
        arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        batch=B, prompt=S, max_new=new, init_s=init_s, generate_s=walls,
        tokens_per_s=B * new / walls[1], **times, **bounds,
        prefill_profile=prof_pre, decode_profile=prof_dec,
        peak_mib=peak / 2**20, held_before_mib=base / 2**20,
        sample=outs[0][0, :16].tolist(), clock="CUDA events (ms), host (s)")
    if cfg.n_experts:
        report.update(capacity_factor=cfg.capacity_factor, prefill_dropped=dropped,
                      prefill_assignments=B * S * cfg.top_k
                      * sum(lay.moe for lay in model.layers),
                      prefill_experts_hit=pre_hits, decode_experts_hit=dec_hits)
    return report, model, engine, prompts


def _log_serve(report, card):
    r = report
    moe = ""
    if "prefill_dropped" in r:
        hits = r["decode_experts_hit"]
        moe = (f", {r['decode_bound_active_ms']:.3f} with the "
               f"{r['decode_active_gb']:.2f} GB the step used; prefill dropped "
               f"{r['prefill_dropped']} of {r['prefill_assignments']} assignments "
               f"at capacity factor {r['capacity_factor']}; a decode step's "
               f"routers chose {min(hits)}-{max(hits)} experts a layer")
    log(f"serve {r['arch']} {r['dtype']} ({r['layers']} layers, {r['params']:,} "
        f"parameters) B={r['batch']} prompt {r['prompt']} +{r['max_new']}: prefill "
        f"{r['prefill_ms']:.3f} ms (bound {r['prefill_bound_ms']:.3f}; "
        f"{r['prefill_tflop']:.2f} TFLOP bf16, {r.get('prefill_f32_tflop', 0):.3f} "
        f"TFLOP float32), decode {r['decode_ms']:.3f} ms a step (bound "
        f"{r['decode_bound_ms']:.3f} with {r['weight_gb']:.2f} GB of weights and "
        f"{r['cache_gb']:.3f} GB of cache traffic{moe}; host "
        f"{r['decode_host_ms']:.3f} ms a step, {min(r['decode_ms_all']):.3f}-"
        f"{max(r['decode_ms_all']):.3f} ms over the steps), "
        f"{r['tokens_per_s']:.1f} tok/s (generate {r['generate_s'][0]:.2f} / "
        f"{r['generate_s'][1]:.2f} s), peak {r['peak_mib']:.1f} MiB over the "
        f"{r['held_before_mib']:.1f} MiB held before, init {r['init_s']:.2f} s [{card}]")
    for what, prof in (("prefill", r["prefill_profile"]),
                       ("decode step", r["decode_profile"])):
        log(f"  one {what}: {prof.get('kernels', 'not measured')} device "
            f"kernels, busy {prof.get('device_busy_ms', 'not measured')} ms "
            f"(share {prof.get('busy_share', 'not measured')})")


def drive_ssm_serve(dev, card):
    """Phase 19 (a): mamba2-2.7b at full width and ``SSM_LAYERS`` layers in
    bfloat16."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_LAYERS)
    report, model, engine, prompts = _serve_phase(dev, cfg,
                                                  SSM_SERVE, SEED + 9)
    _log_serve(report, card)
    del engine
    return report, model, prompts


def drive_ssm_forced(dev, model, prompts):
    """Phase 19 (c): bf16 prefill + forced decode steps on (a)'s weights
    and prompts against bf16 ``forward_train``, sound and with each
    planted fault."""
    cfg = model.cfg
    B, S = prompts.shape
    D = SSM_BF16_FORCED["decode"]
    rng = np.random.default_rng(SEED + 10)
    tokens = np.concatenate(
        [prompts, rng.integers(0, cfg.vocab_size, size=(B, D)).astype(np.int32)], 1)
    r = _ssm_forced(model, cfg, tokens, S, (None, *SSM_BF16_FAULTS))
    readings = {k: v[0] for k, v in r.items()}
    log(f"  bf16 prefill {S} + {D} decode steps against forward_train: "
        + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
        + f" (bar {SSM_BF16_TOL}; max |logit| {r['sound'][2]:.3f}, argmax equal "
        f"{r['sound'][1]})")
    assert readings["sound"] < SSM_BF16_TOL, (readings, SSM_BF16_TOL)
    assert min(readings[f] for f in SSM_BF16_FAULTS) > SSM_BF16_TOL, \
        ("the bar no longer catches a planted fault", readings, SSM_BF16_TOL)
    return dict(prompt=S, decode_steps=D, max_abs_err=readings, tol=SSM_BF16_TOL,
                argmax_equal=r["sound"][1], max_abs_logit=r["sound"][2])


def _f32_forced(dev, cfg, spec, seed, faults=()):
    """float32 with TF32 off: prefill + forced decode steps within the
    reference's bar of ``forward_train``, the same argmax, and each
    planted fault above the bar."""
    from repro_torch.models import init_params

    assert not torch.backends.cuda.matmul.allow_tf32
    B, P, D = spec["batch"], spec["prompt"], spec["decode"]
    torch.cuda.empty_cache()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, P + D)).astype(np.int32)
    r = _ssm_forced(model, cfg, tokens, P, (None, *faults), SSM_FAULT_STEPS)
    dropped = moe_dropped(model)
    del model
    torch.cuda.empty_cache()
    err, same, scale, gap = r.pop("sound")
    faults = {k: v[0] for k, v in r.items()}
    log(f"serve {cfg.name} float32 (TF32 off, {cfg.num_layers} layers"
        + (f", capacity factor {cfg.capacity_factor:g}" if cfg.n_experts else "")
        + f"): prefill {P} + {D} decode steps within {err:.3e} of forward_train "
        f"over {P + D} (bar {LM_F32_TOL}; max |logit| {scale:.3f}, smallest top-2 "
        f"gap {gap:.3e})" + "".join(f"; {k} {v:.3e}" for k, v in faults.items())
        + (f" (faults over the first {SSM_FAULT_STEPS} steps)" if faults else ""))
    assert err < LM_F32_TOL, (err, LM_F32_TOL)
    assert same, "float32 prefill/decode argmax differs from forward_train"
    assert not faults or min(faults.values()) > LM_F32_TOL, ("a planted fault passes",
                                                             faults)
    assert dropped == 0, ("the dropless capacity dropped", dropped)
    return dict(arch=cfg.name, dtype="float32", layers=cfg.num_layers, tf32=False,
                batch=B, prompt=P, decode_steps=D, max_abs_err=err, tol=LM_F32_TOL,
                max_abs_logit=scale, min_top2_gap=gap, faults=faults,
                fault_steps=SSM_FAULT_STEPS if faults else None)


def drive_ssm_f32(dev):
    """Phase 19 (b): mamba2-2.7b in float32 at full width and ``SSM_LAYERS``
    layers."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_LAYERS,
                              dtype="float32")
    return _f32_forced(dev, cfg, SSM_F32, SEED + 11, SSM_FAULTS)


def drive_ssd_scan(dev):
    """Phase 19 (d): ``ssd_chunked`` on the card in float32 against the
    recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = C_t
    h_t`` in float64 on the host, outputs and final state, and the
    "chunk_state" fault above the bar."""
    import repro_torch.models.layers as L
    from repro_torch.configs import get_config

    cfg = get_config(SSM_ARCH)
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H = cfg.ssm_expand * cfg.d_model // P
    B, S = SSD_SCAN["batch"], SSD_SCAN["length"]
    rng = np.random.default_rng(SEED + 12)
    silu = lambda v: v / (1 + np.exp(-v))  # noqa: E731
    xh = silu(rng.normal(size=(B, S, H, P)))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    A = -np.exp(rng.uniform(-1, 1, size=H))
    Bs, Cs = silu(rng.normal(size=(B, S, N))), silu(rng.normal(size=(B, S, N)))
    h = rng.normal(size=(B, H, P, N))
    args = [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (xh, dt, A, Bs, Cs, h)]
    ys = []
    for t in range(S):
        h = (np.exp(dt[:, t] * A)[:, :, None, None] * h
             + (dt[:, t][:, :, None] * xh[:, t])[..., None] * Bs[:, t][:, None, None, :])
        ys.append(np.einsum("bn,bhpn->bhp", Cs[:, t], h))
    want_y, want_h = np.stack(ys, 1), h

    def rel(got, want):
        return np.abs(got.double().cpu().numpy() - want).max() / np.abs(want).max()

    plain = L.chunk_states
    with torch.inference_mode():
        y, hN = L.ssd_chunked(*args[:5], L.SSD_CHUNK, args[5])
        err, err_h = rel(y, want_y), rel(hN, want_h)
        try:
            L.chunk_states = _own_end_states(plain)
            fault = rel(L.ssd_chunked(*args[:5], L.SSD_CHUNK, args[5])[0], want_y)
        finally:
            L.chunk_states = plain
    assert max(err, err_h) < SSD_SCAN_TOL < fault, (err, err_h, SSD_SCAN_TOL, fault)
    log(f"ssd_chunked float32 on the card, B={B} S={S} (2 chunks of "
        f"{L.SSD_CHUNK}) H={H} P={P} N={N}: {err:.3e} (state {err_h:.3e}) of "
        f"max |y| from the float64 recurrence (bar {SSD_SCAN_TOL}); each "
        f"chunk reading its own end state {fault:.3e}")
    return dict(batch=B, length=S, heads=H, rel_err=err, rel_err_state=err_h,
                tol=SSD_SCAN_TOL, fault_chunk_state=fault)


def drive_ssm_cpu_card(dev):
    """Phase 19 (d): reduced mamba2 and reduced jamba, card against CPU."""
    from repro_torch.configs import get_config

    return [drive_lm_cpu_card(dev, get_config(arch).reduced(), SSM_CPU_LEN)
            for arch in SSM_CPU]


def drive_jamba(dev, card):
    """Phase 19 (e): jamba-v0.1-52b at full width and 8 of its 32 layers,
    bf16 at the published capacity factor, then float32 dropless."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(JAMBA["arch"]), num_layers=JAMBA["layers"])
    report, model, engine, _ = _serve_phase(dev, cfg, JAMBA, SEED + 12)
    _log_serve(report, card)
    del model, engine
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype="float32",
                              capacity_factor=cfg.n_experts / cfg.top_k)
    report["float32"] = _f32_forced(dev, f32, JAMBA_F32, SEED + 13)
    return report



# -- phase 20: the training path ------------------------------------------------
TRAIN_ARCH = "qwen2.5-3b"
# (a): full width and 6 of its 36 layers in bf16 with its remat "full",
# AdamW, batches of TokenPipeline(seed=0); (d) saves the state after step 3
# and resumes.  The depth is cut for the script's time limit: at 36 layers
# (a) and (d) took 89 s, most of it the 30.9 GB checkpoint's write and
# restore (PERF.md section 6)
TRAIN = dict(layers=6, batch=8, seq=512, steps=6, save_after=3, seed=0)
TRAIN_OPT = dict(lr=3e-4, warmup=2, total_steps=100)
# (d) saves through save_checkpoint's defaults, the launcher's path: zstd
# when zstandard imports, else zlib's stored form (no zstandard on the
# card's machine); each part of the write and the restore is timed
# (b): reduced configs in float32 with remat on, card against CPU: the
# loss, each gradient leaf and the parameters after two steps, the bar of
# the earlier card-against-CPU checks; two chunks of the Mamba-2 scan.  A
# leaf's gradient is read over its largest entry, or over a millionth of
# the model's largest when that is more: the Mamba layers' A_log
# gradients are 1e-9-2e-8 against a largest entry of 0.3-0.6 (the init's
# fast decays), sums that cancel to 1e-8 of their terms, so float32's
# order of summation moves them by 1e-4 of themselves (2.7e-4 of a 4.2e-9
# leaf on the card); a wrong A_log gradient (1e-8 off) still reads
# 3e-2 over the floor
TRAIN_CPU = ("qwen2.5-3b", "mixtral-8x7b", "mamba2-2.7b", "jamba-v0.1-52b")
TRAIN_CPU_LEN = dict(batch=2, seq=256, steps=2)
TRAIN_CPU_TOL = 1e-4
TRAIN_CPU_FLOOR = 1e-6
# (c): float32 at full width and depth, TF32 off.  For each group of
# parameters (the embedding, each of the 36 layers, the final norm) the
# loss's derivative along the group's own unit direction v = g_G / |g_G|
# from autograd's gradient: autograd's g . v = |g_G| against a central
# difference of the loss along v, Richardson-extrapolated from steps h
# and h / 2; relative error.  Each group's step moves the loss by about
# the same amount, h = dloss / |g_G|: float32's rounding of the loss
# (about 1e-6) over the loss's change sets the sound reading's floor,
# and |g_G| runs from 0.022 (the final norm) to 19.6 (the embedding,
# along which the loss bends sharply: at a fixed h 1e-2 it reads 2.7e-2).
# Planted faults, read along the same directions: the tied head's part of
# the embedding's gradient dropped (from a second backward with the head
# detached); layer 18's gradient zeroed; layer 18's gradient 1 % short.
# On the card the largest sound reading of the 38 groups is 4.2e-3,
# 1.8e-3, 7.1e-4, 3.4e-4 and 1.7e-4 at dloss 5e-4, 1e-3, 2e-3, 5e-3 and
# 1e-2 (the rounding over the loss's change), and the faults read 0.19,
# 1 and 9.1e-3 to 1.06e-2 at each (tools/grad_check_readings.py, NVIDIA
# H100 80GB HBM3, 700 W).  The bar lies between.
GRAD_CHECK = dict(batch=1, seq=128, dloss=1e-2)
GRAD_CHECK_TOL = 1e-3
GRAD_FAULT_LAYER = 18
GRAD_FAULT_SHORT = 0.01
# (e): mamba2-2.7b at full width and depth in bf16, B = 4, S = 512 (four
# chunks of the scan), AdamW, remat "full"
SSM_TRAIN = dict(arch="mamba2-2.7b", batch=4, seq=512, steps=3, seed=1)


def _train_bounds(model, B, S):
    """Least time of a training step as this model computes it: the matmul
    operations (2 a multiply-add) of the forward at the bf16 peak, the
    Mamba-2 scan's float32 contractions at the float32 peak
    (``_mamba_ops``), times 3 for the forward and the backward's two
    products a forward product; remat's recomputed forward (every layer
    and the loss's head once more) on its own line; the optimizer's bytes
    at 3.35 TB/s (AdamW reads the parameter, the gradient and both float32
    moments and writes the moments and the parameter: 22 bytes a bf16
    parameter).  Attention scores and values over the full S x S, as
    computed.  The step runs these one after another: its bound is their
    sum; the largest alone is the roofline of a schedule that overlaps
    them."""
    cfg = model.cfg
    assert cfg.attention != "mla" and not cfg.n_experts
    d, n_tok = cfg.d_model, B * S
    gated = 3 if cfg.act in ("swiglu", "geglu") else 2
    mm, f32 = 2 * n_tok * d * cfg.padded_vocab, 0
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
            mm += 2 * n_tok * d * (2 * H + 2 * KV) * hd + 4 * B * H * S * S * hd
        else:
            o, f = _mamba_ops(cfg, B, n_tok, S)
            mm, f32 = mm + o, f32 + f
        if cfg.d_ff:
            mm += 2 * gated * n_tok * d * cfg.d_ff
    fwd_ms = (mm / PEAK_BF16_OPS_PER_S + f32 / PEAK_OPS_PER_S["float32"]) * 1e3
    opt_bytes = sum(p.numel() * (3 * p.element_size() + 16) for p in model.parameters())
    out = dict(train_tflop=3 * mm / 1e12, train_f32_tflop=3 * f32 / 1e12,
               compute_bound_ms=3 * fwd_ms,
               remat_bound_ms=fwd_ms if cfg.remat else 0.0,
               optimizer_gb=opt_bytes / 1e9,
               optimizer_bound_ms=opt_bytes / PEAK_BYTES_PER_S * 1e3)
    parts = (out["compute_bound_ms"], out["remat_bound_ms"], out["optimizer_bound_ms"])
    out.update(step_bound_ms=sum(parts), roofline_ms=max(parts))
    return out


def _train_steps(dev, model, opt, step, pipe, steps, first=0, on_step=None):
    """``steps`` training steps on the pipeline's batches from ``first``:
    each step's metrics (floats), its device ms (CUDA events) and its
    host ms.  ``on_step(i, model, opt)`` runs after the ``i``-th step
    (counted from 1)."""
    out = []
    for i in range(first, first + steps):
        batch = pipe.batch_at(i)
        (model, opt, m), ms, host = _event_ms(lambda: step(model, opt, batch))
        torch.cuda.synchronize(dev)
        out.append(dict({k: v.item() for k, v in m.items()}, ms=ms, host_ms=host))
        if on_step:
            on_step(i + 1, model, opt)
    return out


def _train_run(dev, cfg, spec, opt_cfg, on_step=None, profile=False):
    """Init ``cfg`` from the seed on the card and train ``spec["steps"]``
    steps on TokenPipeline(seed=spec["seed"]): finite losses and gradient
    norms, parameters that moved; the timings beside the bound, peak
    memory over what was held before; with ``profile`` one more step's
    profile and the step's two parts timed alone.  Returns (report,
    model, optimizer state, step function, pipeline)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import (TrainConfig, apply_updates, grads_of,
                                   init_opt_state, make_train_step)

    torch.zeros(1, device=dev)       # the allocator exists before its reset
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    model.requires_grad_(True)
    opt = init_opt_state(model, opt_cfg)
    state_bytes = torch.cuda.memory_allocated(dev) - base   # model + optimizer
    step = make_train_step(cfg, opt_cfg, TrainConfig())
    B, S = spec["batch"], spec["seq"]
    pipe = TokenPipeline(cfg.padded_vocab, B, S, seed=spec["seed"])
    probe = {n: p.detach().clone() for n, p in list(model.named_parameters())[:3]}
    runs = _train_steps(dev, model, opt, step, pipe, spec["steps"], on_step=on_step)
    peak = torch.cuda.max_memory_allocated(dev) - base
    losses = [r["loss"] for r in runs]
    assert all(math.isfinite(x) for x in losses), losses
    assert all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in runs)
    moved = {n: (p.detach() - probe[n]).abs().max().item()
             for n, p in model.named_parameters() if n in probe}
    assert all(v > 0 for v in moved.values()), ("parameters did not move", moved)
    del probe
    ms = [r["ms"] for r in runs]
    step_ms = statistics.median(ms[1:])
    report = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
                  params=cfg.param_count(),
                  remat=cfg.remat_policy if cfg.remat else "off",
                  batch=B, seq=S, steps=spec["steps"], losses=losses,
                  grad_norms=[r["grad_norm"] for r in runs],
                  lrs=[r["lr"] for r in runs], step_ms_all=ms,
                  host_ms_all=[r["host_ms"] for r in runs], step_ms=step_ms,
                  tokens_per_s=B * S / step_ms * 1e3, peak_mib=peak / 2**20,
                  peak_bytes=peak, state_bytes=state_bytes,
                  held_before_mib=base / 2**20, moved=moved,
                  **_train_bounds(model, B, S), clock="CUDA events (ms), host (s)")
    if profile:
        # one more step under the profiler (its batch the next one), then
        # a step in its two parts: the gradients, and the optimizer's update
        t0 = time.perf_counter()
        batch = pipe.batch_at(spec["steps"])
        report["profile"] = _profiled(dev, lambda: step(model, opt, batch), step_ms)
        (grads, _, _), grads_ms, _ = _event_ms(
            lambda: grads_of(model, batch, cfg, TrainConfig()))
        _, update_ms, _ = _event_ms(lambda: apply_updates(model, grads, opt, opt_cfg))
        report.update(grads_ms=grads_ms, update_ms=update_ms,
                      profile_s=time.perf_counter() - t0)
        del grads
    return report, model, opt, step, pipe


def _log_train(r, card):
    log(f"train {r['arch']} {r['dtype']} ({r['layers']} layers, {r['params']:,} "
        f"parameters, remat {r['remat']}) AdamW B={r['batch']} S={r['seq']}: step "
        f"{r['step_ms']:.2f} ms (median of steps 2-{r['steps']}; "
        f"{min(r['step_ms_all']):.2f}-{max(r['step_ms_all']):.2f}), "
        f"{r['tokens_per_s']:.0f} tokens/s; bound {r['step_bound_ms']:.2f} ms = "
        f"compute {r['compute_bound_ms']:.2f} ({r['train_tflop']:.2f} TFLOP bf16, "
        f"{r['train_f32_tflop']:.3f} TFLOP float32) + remat's recomputed forward "
        f"{r['remat_bound_ms']:.2f} + optimizer {r['optimizer_bound_ms']:.2f} "
        f"({r['optimizer_gb']:.2f} GB); losses "
        + ", ".join(f"{x:.4f}" for x in r["losses"])
        + f"; grad_norm {r['grad_norms'][-1]:.4f}; peak {r['peak_mib']:.1f} MiB over "
        f"the {r['held_before_mib']:.1f} MiB held before [{card}]")
    host = f"the host issues a step in {statistics.median(r['host_ms_all']):.1f} ms"
    if "profile" not in r:
        log(f"  {host} (not profiled)")
        return
    prof = r["profile"]
    log(f"  one step: {prof.get('kernels', 'not measured')} device kernels, busy "
        f"{prof.get('device_busy_ms', 'not measured')} ms (share "
        f"{prof.get('busy_share', 'not measured')}); {host}; its parts: gradients "
        f"{r['grads_ms']:.2f} ms, the optimizer's update {r['update_ms']:.2f} ms "
        f"(the profiled step and the parts: {r['profile_s']:.1f} s)")

def drive_train(dev, card, tmp):
    """Phase 20 (a) and (d): qwen2.5-3b at full width and ``TRAIN["layers"]``
    layers, bf16, AdamW; its state saved after step 3, restored into a fresh model and
    optimizer on the card, and steps 4-6 run again from it: the same
    losses and the same parameters as the run that never stopped, bit for
    bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import load_train_state, train_state
    from repro_torch.models import LM
    from repro_torch.train import (OptConfig, TrainConfig, make_train_step,
                                   restore_checkpoint, save_checkpoint)

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN["layers"])
    assert cfg.dtype == "bfloat16" and cfg.remat and cfg.remat_policy == "full"
    opt_cfg = OptConfig(**TRAIN_OPT)
    k, n, kept = TRAIN["save_after"], TRAIN["steps"], {}

    def after(i, model, opt):
        if i == k:
            torch.cuda.synchronize(dev)
            kept["write"] = {}
            path = save_checkpoint(tmp, i, train_state(model, opt),
                                   timings=kept["write"])
            kept["bytes"] = sum(f.stat().st_size for f in path.iterdir())
        if i == n:       # before the profiled step moves them on
            kept["final"] = {name: p.detach().to("cpu", copy=True)
                             for name, p in model.named_parameters()}

    t0 = time.perf_counter()
    report, model, opt, step, pipe = _train_run(dev, cfg, TRAIN, opt_cfg, after,
                                                profile=True)
    _log_train(report, card)
    del model, opt, step
    torch.cuda.empty_cache()
    report["run_s"] = time.perf_counter() - t0 - kept["write"]["wall_s"]

    # (d): a fresh model and optimizer state from the checkpoint
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fresh = LM(cfg, dev)
    t1 = time.perf_counter()
    read = {}
    tree = restore_checkpoint(tmp, k, device=dev, timings=read)
    t2 = time.perf_counter()
    opt = load_train_state(fresh, opt_cfg, tree, dev)
    del tree
    torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    restore = dict(read, model_s=t1 - t0, load_s=t3 - t2, total_s=t3 - t0)
    assert int(opt["step"]) == k
    fresh.requires_grad_(True)
    again = _train_steps(dev, fresh, opt, make_train_step(cfg, opt_cfg, TrainConfig()),
                         pipe, n - k, first=k)
    got, want = [r["loss"] for r in again], report["losses"][k:]
    assert got == want, ("the resumed run's losses differ", got, want)
    differ = [name for name, p in fresh.named_parameters()
              if not torch.equal(p.detach().cpu(), kept["final"][name])]
    assert not differ, ("the resumed run's parameters differ", len(differ), differ[:4])
    n_params = sum(p.numel() for p in fresh.parameters())
    del fresh, opt, kept["final"]
    torch.cuda.empty_cache()
    write = kept["write"]
    report["checkpoint"] = dict(after_step=k, codec=_ckpt_codec(tmp, k),
                                bytes=kept["bytes"], write=write, restore=restore,
                                resume_s=time.perf_counter() - t0,
                                resumed_losses=got, bit_for_bit=True, clock="host")
    log(f"  checkpoint after step {k}: {kept['bytes']:,} bytes "
        f"({report['checkpoint']['codec']}) written in {write['wall_s']:.2f} s (on "
        f"{write['threads']} threads, thread-seconds: to the host "
        f"{write['host_s']:.2f}, blake2b {write['hash_s']:.2f}, compress "
        f"{write['compress_s']:.2f}; the file writes {write['write_s']:.2f} s); "
        f"restored into a fresh model and optimizer in {restore['total_s']:.2f} s "
        f"(the model {restore['model_s']:.2f} s, restore_checkpoint "
        f"{restore['wall_s']:.2f} s, thread-seconds: read {restore['read_s']:.2f}, "
        f"decompress {restore['decompress_s']:.2f}, blake2b {restore['hash_s']:.2f}, "
        f"onto the card {restore['place_s']:.2f}; loading it {restore['load_s']:.2f} "
        f"s); steps {k + 1}-{n} from it: the same losses and all {n_params:,} "
        f"parameters, bit for bit")
    return report


def _ckpt_codec(directory, step):
    return json.loads((Path(directory) / f"step_{step}" / "manifest.json"
                       ).read_text())["codec"]


def drive_train_cpu_card(dev):
    """Phase 20 (b): reduced configs in float32 with remat on, the same
    parameters and batches on the card and on the CPU: the loss, every
    gradient leaf and the parameters after two AdamW steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import (OptConfig, TrainConfig, grads_of,
                                   init_opt_state, make_train_step)

    assert not torch.backends.cuda.matmul.allow_tf32
    B, S, steps = TRAIN_CPU_LEN["batch"], TRAIN_CPU_LEN["seq"], TRAIN_CPU_LEN["steps"]
    opt_cfg = OptConfig(lr=1e-3, warmup=1, total_steps=10)
    reports = []
    for arch in TRAIN_CPU:
        cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
        host = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        card = lm_params_from_arrays(cfg, lm_params_to_arrays(host), device=dev)
        pipe = TokenPipeline(cfg.padded_vocab, B, S, seed=SEED)
        out = {}
        for side, model in (("cpu", host), ("card", card)):
            model.requires_grad_(True)
            g, loss, m = grads_of(model, pipe.batch_at(0), cfg, TrainConfig())
            grads = {k: v.cpu() for k, v in g.items()}
            del g
            opt = init_opt_state(model, opt_cfg)
            step = make_train_step(cfg, opt_cfg, TrainConfig())
            losses = [step(model, opt, pipe.batch_at(i))[2]["loss"].item()
                      for i in range(steps)]
            out[side] = dict(loss=loss.item(), aux=m["aux"].item(), grads=grads,
                             losses=losses, drops=moe_dropped(model),
                             params={k: p.detach().cpu()
                                     for k, p in model.named_parameters()})
        h, c = out["cpu"], out["card"]
        loss_err = max([abs(h["loss"] - c["loss"]), abs(h["aux"] - c["aux"])]
                       + [abs(a - b) for a, b in zip(h["losses"], c["losses"])])
        top = max(g.abs().max().item() for g in h["grads"].values())
        grad_err = max((c["grads"][k] - g).abs().max().item()
                       / max(g.abs().max().item(), TRAIN_CPU_FLOOR * top)
                       for k, g in h["grads"].items())
        param_err = max((c["params"][k] - p).abs().max().item()
                        for k, p in h["params"].items())
        assert max(loss_err, grad_err, param_err) < TRAIN_CPU_TOL, \
            (arch, loss_err, grad_err, param_err)
        assert h["drops"] == c["drops"], (h["drops"], c["drops"])
        log(f"train {cfg.name} reduced float32 (remat full) B={B} S={S}: card "
            f"against CPU: loss {loss_err:.3e}, gradients {grad_err:.3e} of each "
            f"leaf's largest entry (at least {TRAIN_CPU_FLOOR:g} of the model's "
            f"{top:.3e}), parameters after {steps} AdamW steps "
            f"{param_err:.3e} (bar {TRAIN_CPU_TOL})")
        reports.append(dict(arch=cfg.name, reduced=True, batch=B, seq=S, steps=steps,
                            loss=c["loss"], loss_err=loss_err, grad_rel_err=grad_err,
                            param_err=param_err, tol=TRAIN_CPU_TOL))
        del host, card, out
    torch.cuda.empty_cache()
    return reports


def _param_group(name: str) -> str:
    """The group a parameter's gradient is checked in: ``layers.<i>`` for a
    layer's, else its module (``embed``, ``final_norm``)."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else parts[0]


def drive_grad_check(dev, card):
    """Phase 20 (c): float32 at full width and depth, TF32 off: for each
    group of parameters, autograd's derivative of the loss along the
    group's unit gradient direction v (that is |g_G|) against a central
    difference of the loss along v, Richardson-extrapolated from steps h
    and h / 2 (h = dloss / |g_G|); and the planted faults' readings along
    the same directions
    (the tied head's part of the embedding's gradient dropped, from a
    second backward with the head detached; layer ``GRAD_FAULT_LAYER``'s
    gradient zeroed, and ``GRAD_FAULT_SHORT`` short).  Returns the
    readings; phase 20 holds them to the bar."""
    import dataclasses

    import repro_torch.train.train_step as ts
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import TrainConfig, grads_of, loss_fn

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    assert cfg.tie_embeddings
    B, S, dloss = (GRAD_CHECK[k] for k in ("batch", "seq", "dloss"))
    tcfg = TrainConfig()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    model.requires_grad_(True)
    batch = TokenPipeline(cfg.padded_vocab, B, S, seed=SEED).batch_at(0)
    grads, loss0, _ = grads_of(model, batch, cfg, tcfg)

    def dot(a, b):
        return torch.sum(a * b, dtype=torch.float64).item()

    groups = {}
    for n, p in model.named_parameters():
        groups.setdefault(_param_group(n), []).append((n, p))
    norms = {gname: math.sqrt(sum(dot(grads[n], grads[n]) for n, _ in members))
             for gname, members in groups.items()}

    def central(members, norm, step_h):
        theta = [p.detach().clone() for _, p in members]

        def loss_at(t):
            with torch.no_grad():
                for (n, p), p0 in zip(members, theta):
                    torch.add(p0, grads[n], alpha=t / norm, out=p)
                return loss_fn(model, batch, cfg, tcfg)[0].item()

        fd = (loss_at(step_h) - loss_at(-step_h)) / (2 * step_h)
        fd2 = (loss_at(step_h / 2) - loss_at(-step_h / 2)) / step_h
        with torch.no_grad():
            for (_, p), p0 in zip(members, theta):
                p.copy_(p0)
        return (4 * fd2 - fd) / 3

    fds = {gname: central(members, norms[gname], dloss / norms[gname])
           for gname, members in groups.items()}
    sound = {gname: abs(norms[gname] - fds[gname]) / abs(fds[gname]) for gname in groups}
    # the tied head's part dropped: the embedding's gradient of the lookup
    plain_head = ts.lm_head_of
    try:
        ts.lm_head_of = lambda m, c: m.embed.T.detach()
        loss, _ = loss_fn(model, batch, cfg, tcfg)
        (lookup,) = torch.autograd.grad(loss, [model.embed])
    finally:
        ts.lm_head_of = plain_head
    lookup_along = dot(lookup, grads["embed"]) / norms["embed"]
    del lookup, loss
    layer = f"layers.{GRAD_FAULT_LAYER}"

    def off(got, group):
        return abs(got - fds[group]) / abs(fds[group])

    faults = {"tied_head": off(lookup_along, "embed"),
              "layer_zeroed": off(0.0, layer),
              "layer_short": off((1 - GRAD_FAULT_SHORT) * norms[layer], layer)}
    del model, grads
    torch.cuda.empty_cache()
    worst = max(sound, key=sound.get)
    seconds = time.perf_counter() - t_start
    log(f"train {cfg.name} float32 (TF32 off, {cfg.num_layers} layers) B={B} S={S}: "
        f"loss {loss0.item():.6f}; autograd along each group's g/|g| against central "
        f"differences (h = {dloss} / |g_G| and h / 2, extrapolated) over "
        f"{len(groups)} groups: "
        f"sound {min(sound.values()):.3e}-{sound[worst]:.3e} (the largest {worst}, "
        f"|g| {norms[worst]:.4e}; embed {sound['embed']:.3e}, |g| "
        f"{norms['embed']:.4e}); faults "
        + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
        + f" ({layer}, |g| {norms[layer]:.4e}; bar {GRAD_CHECK_TOL}; "
        f"{seconds:.1f} s) [{card}]")
    return dict(arch=cfg.name, dtype="float32", tf32=False, batch=B, seq=S,
                loss=loss0.item(), dloss=dloss, groups=len(groups), grad_norms=norms,
                fd_extrapolated=fds, sound=sound, sound_max=sound[worst],
                sound_worst=worst, faults=faults, fault_layer=GRAD_FAULT_LAYER,
                tol=GRAD_CHECK_TOL, seconds=seconds)


def judge_grad_check(r):
    """Phase 20 (c)'s bar: every group's sound reading under it, every
    planted fault above it."""
    assert r["sound_max"] < GRAD_CHECK_TOL, ("a sound reading is over the bar",
                                             r["sound_worst"], r["sound_max"])
    assert min(r["faults"].values()) > GRAD_CHECK_TOL, \
        ("the bar no longer catches a planted fault", r["faults"])


def drive_ssm_train(dev, card):
    """Phase 20 (e): mamba2-2.7b at full width and depth, bf16, AdamW:
    the SSD scan's backward on the card (not profiled: the step's host
    issue time beside its device time says whether the host holds it)."""
    from repro_torch.configs import get_config
    from repro_torch.train import OptConfig

    cfg = get_config(SSM_TRAIN["arch"])
    report, model, opt, step, _ = _train_run(dev, cfg, SSM_TRAIN, OptConfig(**TRAIN_OPT))
    _log_train(report, card)
    del model, opt, step
    torch.cuda.empty_cache()
    return report


def drive_phase20(dev, card, scratch):
    """Phase 20, (a)-(e), each sub-phase's seconds in the report (the
    launcher and its resume, once (f), are phase 22 (a)'s one-process
    runs)."""
    t20 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        report = drive_train(dev, card, Path(tmp) / "ckpt")
    ck = report["checkpoint"]
    seconds = {"a": report["run_s"], "d write": ck["write"]["wall_s"],
               "d restore and steps 4-6": ck["resume_s"]}

    def timed(part, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[part] = time.perf_counter() - t0
        return out

    report["cpu_card"] = timed("b", lambda: drive_train_cpu_card(dev))
    report["grad_check"] = timed("c", lambda: drive_grad_check(dev, card))
    judge_grad_check(report["grad_check"])
    report["mamba2"] = timed("e", lambda: drive_ssm_train(dev, card))
    report.update(seconds=seconds, phase_s=time.perf_counter() - t20)
    log("phase 20 seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in seconds.items()))
    log(f"phase 20: {report['phase_s']:.1f} s")
    return report


# -- phase 21: the dry run ------------------------------------------------------
# (a) the CLI over every arch at train_4k and decode_32k on the 16x16 mesh,
# in four processes at once (each its own fake process group), grouped so
# that their traces take about as long (jamba's 8-layer pattern alone)
DRYRUN_GROUPS = (("jamba-v0.1-52b",),
                 ("whisper-base", "deepseek-v2-lite-16b", "mamba2-2.7b"),
                 ("mixtral-8x7b", "nemotron-4-340b", "phi-3-vision-4.2b", "qwen2.5-3b"),
                 ("stablelm-1.6b", "stablelm-3b"))
DRYRUN_SHAPES = ("train_4k", "decode_32k")
# (b) phase 20's step (qwen2.5-3b, bf16, AdamW, remat "full", B = 8,
# S = 512) as a cell on a 1 x 1 mesh: its argument bytes against what the
# card allocated for the model and AdamW's moments
DRYRUN_CARD = dict(arch="qwen2.5-3b", batch=8, seq=512)
DRYRUN_CARD_TOL = 0.01


def dryrun_cmds(out) -> list:
    """Phase 21 (a)'s processes: ``python -m repro_torch.launch.dryrun``
    over every arch at ``DRYRUN_SHAPES`` on the 16x16 mesh, one process
    a group of ``DRYRUN_GROUPS``, each cell's record into ``out``."""
    return [cli_cmd("repro_torch.launch.dryrun",
                    ["--arch", ",".join(g), "--shape", ",".join(DRYRUN_SHAPES),
                     "--mesh", "single", "--out", str(out)])
            for g in DRYRUN_GROUPS]


def drive_dryrun_sweep(out, results) -> dict:
    """Phase 21 (a): the dry run's processes (``results`` of
    :func:`run_at_once` over :func:`dryrun_cmds`): every cell ok; each
    cell's dominant term, its three terms (H100 constants, not measured)
    and its per-card bytes."""
    for rc, stdout, stderr, _ in results:
        assert rc == 0, (rc, stdout[-2000:], stderr[-2000:])
    wall = max(r[3] for r in results)
    out = Path(out)
    recs = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
    n_cells = sum(len(g) for g in DRYRUN_GROUPS) * len(DRYRUN_SHAPES)
    assert len(recs) == n_cells and all(r["ok"] for r in recs), \
        [(r["arch"], r["shape"], r.get("error")) for r in recs if not r["ok"]]
    cells = []
    for r in recs:
        x, m = r["roofline"], r["memory"]
        cells.append(dict(arch=r["arch"], shape=r["shape"], dominant=x["dominant"],
                          compute_s=x["compute_s"], memory_s=x["memory_s"],
                          collective_s=x["collective_s"], trace_s=r["trace_s"],
                          argument_bytes_per_device=m["argument_bytes_per_device"],
                          temp_bytes_per_device=m["temp_bytes_per_device"]))
        log(f"dryrun {r['arch']} {r['shape']} 16x16: {x['dominant']}-bound (compute "
            f"{x['compute_s']:.4g} s, memory {x['memory_s']:.4g} s, collective "
            f"{x['collective_s']:.4g} s; H100 constants, not measured); per card: "
            f"arguments {m['argument_bytes_per_device'] / 1e9:.3f} GB, temp "
            f"{m['temp_bytes_per_device'] / 1e9:.3f} GB; trace {r['trace_s']} s")
    log(f"dryrun: {len(recs)} cells ok in {wall:.1f} s ({len(DRYRUN_GROUPS)} processes)")
    return dict(cells=cells, wall_s=wall, clock="host")


def drive_dryrun_card(train_report, card) -> dict:
    """Phase 21 (b): phase 20's qwen2.5-3b step as a dry-run cell on a 1 x 1
    mesh: its argument bytes within ``DRYRUN_CARD_TOL`` of the card's
    allocation for the model and AdamW's moments (phase 20 (a)); its temp
    bytes beside the step's measured peak over them, its bound beside
    ``_train_bounds``' and the measured step."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.sharding import MeshShape, make_rules
    from repro_torch.launch.dryrun import measure_cell

    r = train_report
    cfg = dataclasses.replace(get_config(DRYRUN_CARD["arch"]), num_layers=r["layers"])
    assert (r["arch"], r["batch"], r["seq"], r["dtype"]) == (
        cfg.name, DRYRUN_CARD["batch"], DRYRUN_CARD["seq"], cfg.dtype)
    shape = ShapeSpec("phase20", DRYRUN_CARD["seq"], DRYRUN_CARD["batch"], "train")
    t0 = time.perf_counter()
    cell = measure_cell(cfg, shape, MeshShape(("data", "model"), (1, 1)), make_rules(cfg))
    wall = time.perf_counter() - t0
    mem, roof = cell["memory"], cell["roofline"]
    args, held = mem["argument_bytes_per_device"], r["state_bytes"]
    rel = abs(args - held) / held
    assert rel <= DRYRUN_CARD_TOL, (args, held, rel)
    measured_temp = r["peak_bytes"] - held
    out = dict(argument_bytes=args, allocated_bytes=held, rel_diff=rel,
               temp_bytes=mem["temp_bytes_per_device"], measured_peak_over_state=measured_temp,
               compute_s=roof.compute_s, memory_s=roof.memory_s,
               collective_s=roof.collective_s, bound_ms=roof.bound_s * 1e3,
               dominant=roof.dominant, train_bound_ms=r["step_bound_ms"],
               step_ms=r["step_ms"], cost_source=cell["cost_source"], wall_s=wall)
    log(f"dryrun {cfg.name} B={shape.global_batch} S={shape.seq_len} 1x1: argument bytes "
        f"{args:,} against {held:,} allocated for the model and AdamW's moments "
        f"({rel:.2e} apart, bar {DRYRUN_CARD_TOL})")
    log(f"  temp bytes {mem['temp_bytes_per_device']:,} (trace) beside the measured step's "
        f"peak {measured_temp:,} over them [{card}]")
    log(f"  bound {roof.bound_s * 1e3:.2f} ms ({roof.dominant}: compute "
        f"{roof.compute_s * 1e3:.2f}, memory {roof.memory_s * 1e3:.2f}, collective "
        f"{roof.collective_s * 1e3:.2f} ms; H100 constants, not measured) beside "
        f"_train_bounds' {r['step_bound_ms']:.2f} ms and the measured step "
        f"{r['step_ms']:.2f} ms [{card}]; the cell in {wall:.1f} s")
    return out


def drive_phase21(card, train_report, sweep) -> dict:
    """Phase 21: (a) the sweep, whose processes ran beside phase 16 (f)'s
    CLIs, and (b) phase 20's step as a cell."""
    t21 = time.perf_counter()
    report = {"sweep": sweep}
    report["card"] = drive_dryrun_card(train_report, card)
    report["phase_s"] = time.perf_counter() - t21
    log(f"phase 21: {report['phase_s']:.1f} s")
    return report


# -- phase 22: the training step on a mesh of ranks ---------------------------
# (a) qwen2.5-3b at full width and 4 of its 36 layers through the launcher
# under torch.distributed.run on meshes 2 x 1 and 1 x 2, one rank a card
# over NCCL (on one card a 1 x 1 NCCL mesh: gloo does not carry the step's
# collectives on card tensors, PERF.md section 6), float32 and bf16,
# against the one-process launcher run, whose resume of the first mesh's
# checkpoint is phase 20 (f)'s resume
MESH_ARGS = ["--arch", "qwen2.5-3b", "--layers", "4", "--batch", "8", "--seq", "512",
             "--steps", "3", "--log-every", "1", "--lr", "3e-4", "--seed", "0"]
# mamba2-2.7b at full width and 4 of its 64 layers, the same batch and steps
MESH_SSM_ARGS = ["--arch", "mamba2-2.7b", *MESH_ARGS[2:]]
MESH_MODELS = (("qwen2.5-3b", MESH_ARGS), ("mamba2-2.7b", MESH_SSM_ARGS))
# the other configs at full width, float32 alone, the same batch and
# steps, after MESH_MODELS' runs: whisper-base at its full depth (6 + 6
# layers), phi-3-vision-4.2b and stablelm-3b at 4 layers, mixtral-8x7b at
# 1 of its 32 (20.6 GB of model and moments, a peak of 36.9 GB: never
# two of its runs at once)
MESH_MORE = tuple((arch, ["--arch", arch, "--layers", str(n), *MESH_ARGS[4:]])
                  for arch, n in (("whisper-base", 6), ("phi-3-vision-4.2b", 4),
                                  ("stablelm-3b", 4), ("mixtral-8x7b", 1)))
MESH_SHAPES = ((2, 1), (1, 2))
MESH_LOSS_TOL, MESH_PARAM_TOL, MESH_BF16_TOL = 1e-5, 2e-3, 1e-2
# each parameter leaf after the steps against the one-process run's, as a
# share of that run's own change from the initial parameters (norms of the
# differences): an optimizer that moved nothing reads 1
MESH_MOVE_TOL = 0.1
MESH_MEM_TOL = 0.01          # each rank's allocation against cell_memory
# MESH_MORE's runs write no checkpoint (phase 20's and qwen's and
# mamba2's already write some 40 GB, and a machine may cap a run's disk
# writes near that): each parameter leaf is read whole at the end of a run, its
# bytes hashed (a 1 x 1 mesh is one process bit for bit) and this many of
# its entries kept for the float32 bars on several ranks
MESH_SAMPLES = 1 << 16
MESH_TIMEOUT = 600           # one launcher run, its processes included
# (b) with 4 cards or more: full width, bf16, 2 x 2 (and 4 x 1 for qwen):
# (arch, mesh, layers (0: all), the run's own arguments after the common
# ones); nemotron-4-340b at 1 of its 96 layers (2 do not fit an 80 GB
# card), mixtral-8x7b at 8 of its 32 over a sequence longer than its band
# (the common arguments first: the run's own override them)
MESH_FULL = (("deepseek-v2-lite-16b", (2, 2), 0, ()), ("qwen2.5-3b", (2, 2), 0, ()),
             ("qwen2.5-3b", (4, 1), 0, ()), ("jamba-v0.1-52b", (2, 2), 8, ()),
             ("nemotron-4-340b", (2, 2), 1, ()),
             ("mixtral-8x7b", (2, 2), 8, ("--seq", "5120", "--batch", "4")),
             ("phi-3-vision-4.2b", (2, 2), 0, ()), ("whisper-base", (2, 2), 0, ()),
             ("stablelm-1.6b", (2, 2), 0, ()))
MESH_FULL_ARGS = ["--batch", "8", "--seq", "512", "--steps", "3", "--log-every", "1",
                  "--lr", "3e-4", "--seed", "0"]


def _torchrun(nproc: int, args: list, env_extra=None, timeout=MESH_TIMEOUT):
    """``python -m torch.distributed.run --standalone`` from the repo root;
    (exit code, rank 0's stdout, the tail of the output, wall seconds).
    Past ``timeout`` the launcher and its ranks are killed and
    ``subprocess.TimeoutExpired`` raised."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), **(env_extra or {}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "--tee", "3", *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=root, env=env)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_tree(proc.pid)
        proc.communicate()
        raise
    rank0 = "\n".join(ln.split(":", 1)[1] for ln in stdout.splitlines()
                      if ln.startswith("[default0]:"))
    text = stdout + stderr
    errors = [ln for ln in text.splitlines() if "Error" in ln and "ChildFailed" not in ln]
    tail = "\n".join(errors[-12:]) + "\n" + text[-1500:]
    return proc.returncode, rank0, tail, time.perf_counter() - t0


def _kill_tree(pid: int):
    """SIGKILL ``pid`` and every process under it (torch.distributed.run
    starts each rank in a session of its own, which outlives it)."""
    import os
    import signal

    tree, todo = [], [pid]
    while todo:
        p = todo.pop()
        tree.append(p)
        try:
            todo += [int(c) for c in Path(f"/proc/{p}/task/{p}/children").read_text().split()]
        except OSError:
            pass
    for p in tree:
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


def mesh_rank_main(out_dir: str, dtype: str, argv: list) -> int:
    """One rank of a launcher run (``--mesh-rank DIR DTYPE -- ARGS``, under
    torch.distributed.run or alone): ``repro_torch.launch.train.main``
    with the config's weights in ``DTYPE``, the run's batch and sequence,
    the card's allocation read once the model and the optimizer state
    exist, each step timed (synchronised), each checkpoint's save and
    resume timed with its parts (``save_checkpoint``'s and
    ``iter_checkpoint``'s ``timings``: to the host, hash, compress, write
    or read seconds), and the card's and the host's peak memory read;
    ``DIR/rank<r>.json`` gets them.  ``MESH_RANK_STATE`` in the
    environment records the state at the end: ``blocks``, the SHA-256 of
    the bytes of the rank's block of every parameter and moment, in that
    json (``tools/mesh_checkpoint.py`` reads them); ``leaves``, each
    parameter leaf gathered whole, its bytes' SHA-256 and its values at
    ``_sample_at``'s positions, into ``DIR/leaves.pt`` (rank 0)."""
    import dataclasses
    import os

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint as ck

    import resource

    rank = int(os.environ.get("RANK", 0))
    rec = {"rank": rank, "step_ms": [], "save_s": [], "save_parts": []}
    plain_cfg, plain_init, plain_step = lt.build_cfg, lt.init_opt_state, lt.make_train_step
    plain_save, plain_resume = lt.Checkpointer.maybe_save, lt.resume_on_mesh
    plain_write, plain_read = ck.save_checkpoint, lt.iter_checkpoint
    last = {}

    def local_bytes(tensors):
        return sum((t.to_local() if is_dtensor(t) else t).nbytes for t in tensors)

    card = torch.cuda.is_available()    # a CPU rehearsal reads the blocks alone
    sync = torch.cuda.synchronize if card else (lambda: None)

    def measured_init(model, cfg, device=None):
        state = plain_init(model, cfg, device)
        if str(device) != "meta":
            sync()
            rec["param_bytes"] = local_bytes(model.parameters())
            rec["moment_bytes"] = local_bytes(
                t for k, v in state.items() if k != "step" for t in v.values())
            rec["allocated_bytes"] = (torch.cuda.memory_allocated() if card else
                                      rec["param_bytes"] + rec["moment_bytes"])
        return state

    def timed_step(*a, **k):
        step = plain_step(*a, **k)

        def run(*args):
            sync()
            t0 = time.perf_counter()
            out = step(*args)
            sync()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            last["model"], last["opt"] = out[0], out[1]
            return out
        return run

    def timed_save(self, step, tree, force=False, blocking=True):
        t0 = time.perf_counter()
        out = plain_save(self, step, tree, force, blocking)
        if force or (self.every and step % self.every == 0 and step > 0):
            rec["save_s"].append(time.perf_counter() - t0)
        return out

    def write_with_parts(*a, **k):
        rec["save_parts"].append({})
        return plain_write(*a, **k, timings=rec["save_parts"][-1])

    def read_with_parts(*a, **k):
        rec["resume_parts"] = {}
        return plain_read(*a, **k, timings=rec["resume_parts"])

    def timed_resume(model, *a, **k):
        t0 = time.perf_counter()
        out = plain_resume(model, *a, **k)
        rec["resume_s"] = time.perf_counter() - t0
        last["model"], last["opt"] = model, out
        return out

    def build_cfg(args):
        rec["batch"], rec["seq"] = args.batch, args.seq
        return dataclasses.replace(plain_cfg(args), dtype=dtype)

    lt.build_cfg = build_cfg
    lt.init_opt_state, lt.make_train_step = measured_init, timed_step
    lt.Checkpointer.maybe_save, lt.resume_on_mesh = timed_save, timed_resume
    ck.save_checkpoint, lt.iter_checkpoint = write_with_parts, read_with_parts
    if card:
        torch.cuda.reset_peak_memory_stats()
    # the group outlives the launcher's main until the state is read
    dist, done = torch.distributed, torch.distributed.destroy_process_group
    dist.destroy_process_group = lambda *a, **k: None
    try:
        lt.main(argv)
    finally:
        dist.destroy_process_group = done
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if card else 0
    rec["host_peak_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    state = os.environ.get("MESH_RANK_STATE")
    if state == "blocks":
        # the rank's blocks of every parameter and moment after the last
        # step (or after a resume that took none)
        def block(t):
            return _sha(t.to_local() if is_dtensor(t) else t)

        rec["hash"] = {n: block(p) for n, p in last["model"].named_parameters()}
        rec["opt_hash"] = {f"{k}/{path}": block(t) for k, v in last["opt"].items()
                           if k != "step" for path, t in v.items()}
    elif state == "leaves":
        leaves = {}
        for n, p in last["model"].named_parameters():
            whole = (p.full_tensor() if is_dtensor(p) else p).detach()
            if rank == 0:
                leaves[n] = (_sha(whole), _samples(n, whole))
            del whole
        if rank == 0:
            torch.save(leaves, Path(out_dir, "leaves.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def _sha(t) -> str:
    """The SHA-256 of a tensor's bytes."""
    import hashlib

    t = t.detach().contiguous().reshape(-1)
    return hashlib.sha256(t.view(torch.uint8).cpu().numpy()).hexdigest()


def _sample_at(name: str, n: int):
    """The positions of a leaf of ``n`` entries that phase 22 compares on
    several ranks: all of them up to ``MESH_SAMPLES``, else that many drawn
    from a generator seeded with the leaf's name."""
    import zlib

    if n <= MESH_SAMPLES:
        return torch.arange(n)
    g = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    return torch.randint(n, (MESH_SAMPLES,), generator=g)


def _samples(name: str, leaf):
    """A whole leaf's float32 values at ``_sample_at``'s positions, on the
    host."""
    flat = leaf.detach().reshape(-1)
    return flat[_sample_at(name, flat.numel()).to(flat.device)].float().cpu()


def _launcher_run(tmp: Path, name: str, argv: list, dtype: str, mesh=None,
                  timeout=MESH_TIMEOUT, env_extra=None):
    """The launcher once, its weights in ``dtype``: alone (``mesh`` None)
    or under torch.distributed.run with a rank a mesh position, with
    ``env_extra`` in its environment; its lines, history and each rank's
    record."""
    out_dir = tmp / name
    out_dir.mkdir(parents=True)
    argv = [*argv, "--metrics-out", str(out_dir / "history.json")]
    me = str(Path(__file__).resolve())
    if mesh is None:
        import os

        root = Path(__file__).resolve().parent
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, me, "--mesh-rank", str(out_dir), dtype, "--",
                            *argv], capture_output=True, text=True, cwd=root,
                           env={**os.environ, **(env_extra or {})}, timeout=timeout)
        rc, out, tail, wall = (p.returncode, p.stdout, (p.stdout + p.stderr)[-3000:],
                               time.perf_counter() - t0)
    else:
        d, m = mesh
        argv += ["--data-parallel", str(d), "--model-parallel", str(m)]
        rc, out, tail, wall = _torchrun(d * m, [me, "--mesh-rank", str(out_dir), dtype,
                                                "--", *argv], env_extra, timeout)
    assert rc == 0, (name, rc, tail)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    ranks = [json.loads(p.read_text()) for p in sorted(out_dir.glob("rank*.json"))]
    hist = json.loads((out_dir / "history.json").read_text())
    log(f"launcher {name}: exit 0 in {wall:.1f} s, {len(ranks)} rank(s): "
        + " | ".join(lines))
    return dict(name=name, wall_s=wall, lines=lines, history=hist, ranks=ranks, mesh=mesh,
                dir=out_dir)


def _ckpt_params(directory, step: int):
    """The parameters alone (its moments not read) of the checkpoint of
    ``step``."""
    from repro_torch.convert import flatten_paths, nest_paths
    from repro_torch.train.checkpoint import restore_checkpoint

    manifest = json.loads((Path(directory) / f"step_{step}" / "manifest.json").read_text())
    like = nest_paths({k: None for k in manifest["leaves"] if k.startswith("params/")})
    tree = restore_checkpoint(directory, step, like)
    return {k: v.float() for k, v in flatten_paths(tree["params"]).items()}


def _check_memory(run, cfg, card) -> list:
    """Each rank's allocation for the model and its moments against
    ``cell_memory``'s on a ``MeshShape`` of the run's mesh, for the batch
    and sequence the rank recorded (its ``alias``: the parameters and the
    optimizer state; its ``argument`` adds the step's batch, which the
    card holds only inside a step)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import MeshShape, make_rules
    from repro_torch.launch.dryrun import cell_memory

    d, m = run["mesh"] or (1, 1)
    out = []
    for r in run["ranks"]:
        B, S = r["batch"], r["seq"]
        mem = cell_memory(cfg, ShapeSpec("phase22", S, B, "train"),
                          MeshShape(("data", "model"), (d, m)), make_rules(cfg))
        held = r["allocated_bytes"]
        rel = abs(mem["alias"] - held) / held
        log(f"  {run['name']} rank {r['rank']} ({d} x {m}, B = {B}, S = {S}): {held:,} "
            f"bytes allocated for the model and its moments (blocks "
            f"{r['param_bytes'] + r['moment_bytes']:,}) against cell_memory's "
            f"{mem['alias']:,} ({rel:.2e} apart, bar {MESH_MEM_TOL}; with the batch "
            f"{mem['argument']:,}); peak {r['peak_bytes']:,}; host peak "
            f"{r['host_peak_bytes']:,}; steps "
            f"{', '.join(f'{t:.1f}' for t in r['step_ms'])} ms [{card}]")
        assert rel <= MESH_MEM_TOL, (run["name"], r["rank"], held, mem["alias"])
        out.append(dict(rank=r["rank"], batch=B, seq=S, allocated=held,
                        cell_memory=mem["alias"], argument=mem["argument"], rel=rel,
                        peak=r["peak_bytes"], host_peak=r["host_peak_bytes"],
                        step_ms=r["step_ms"]))
    return out


def _initial_params(cfg, seed: int) -> dict:
    """The launcher's initial parameters (``init_params`` from ``seed`` on
    card 0, or on the CPU without a card) in the checkpoint's layout,
    float32 on the host."""
    from repro_torch.convert import flatten_paths, lm_params_to_tensors
    from repro_torch.models import init_params

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    out = {k: v.float().cpu() for k, v in flatten_paths(lm_params_to_tensors(model)).items()}
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _initial_samples(cfg, seed: int) -> dict:
    """The launcher's initial parameters (as ``_initial_params``) at
    ``_sample_at``'s positions, by parameter name."""
    from repro_torch.models import init_params

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    out = {n: _samples(n, p) for n, p in model.named_parameters()}
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _moved_share(got: dict, want: dict, start: dict) -> tuple:
    """The worst leaf's ``|got - want| / |want - start|`` (norms over the
    leaf) and its path: 0 when ``got`` is ``want``, 1 when ``got`` never
    moved from ``start``."""
    def one(k):
        gap, own = (got[k] - want[k]).norm().item(), (want[k] - start[k]).norm().item()
        return gap / own if own else (0.0 if gap == 0 else math.inf)

    share = {k: one(k) for k in want}
    worst = max(share, key=share.get)
    return share[worst], worst


def drive_mesh_train(card, scratch) -> dict:
    """Phase 22 (a): qwen2.5-3b and mamba2-2.7b, then the configs of
    ``MESH_MORE``."""
    import dataclasses

    from repro_torch.configs import get_config

    n_cards = torch.cuda.device_count()
    shapes = MESH_SHAPES if n_cards >= 2 else ((1, 1),)
    report = {"cards": n_cards, "shapes": [list(x) for x in shapes]}
    if n_cards < 2:
        log("phase 22: one card, and NCCL takes one rank a card: the meshes run as "
            "1 x 1 over NCCL on it; no collective crossed ranks")
    seed = int(MESH_ARGS[MESH_ARGS.index("--seed") + 1])
    (qwen, qargs), (ssm, sargs) = MESH_MODELS
    runs = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)

        def f32(arch, args, mesh=None):        # float32 with its checkpoint
            tag = "one" if mesh is None else f"{mesh[0]}x{mesh[1]}"
            return (f"{arch} {tag} f32", [*args, "--ckpt-dir", str(tmp / f"ck-{arch}-{tag}")],
                    "float32", mesh, None)

        def bf16(arch, args, mesh=None):
            tag = "one" if mesh is None else f"{mesh[0]}x{mesh[1]}"
            return f"{arch} {tag} bf16", args, "bfloat16", mesh, None

        def leaves(arch, mesh=None):           # float32, its leaves read at the end
            tag = "one" if mesh is None else f"{mesh[0]}x{mesh[1]}"
            return (f"{arch} {tag} f32", dict(MESH_MORE)[arch], "float32", mesh,
                    {"MESH_RANK_STATE": "leaves"})

        # lanes of runs at once (the runs share the card), in two stages
        # whose peaks fit the card together (on an H100 80GB, float32 /
        # bf16: qwen 20.2 / 18.9 GB, mamba2 9.5 / 8.6, mixtral 36.9,
        # phi-3-vision 12.6, whisper 12.3, stablelm 11.9; four lanes at
        # 68.8 GB ran, four at 71.3 ran the card out of memory): qwen's
        # meshes in float32, then one process's resume of the first one's
        # checkpoint; mamba2's meshes; qwen's meshes in bf16 and its
        # one-process bf16 run; the other one-process runs; then, while
        # qwen's and mamba2's runs are checked, mixtral's runs (62.1 GB at
        # most beside the other two lanes); whisper's runs and
        # phi-3-vision's meshes; stablelm's runs and phi-3-vision's one
        resume = ("resume", [*qargs, "--steps", "4", "--ckpt-dir",
                             str(tmp / f"ck-{qwen}-{shapes[0][0]}x{shapes[0][1]}")],
                  "float32", None, None)

        def both(arch):
            return [*(leaves(arch, x) for x in shapes), leaves(arch)]

        phi = "phi-3-vision-4.2b"
        stages = [[[*(f32(qwen, qargs, x) for x in shapes), resume],
                   [*(f32(ssm, sargs, x) for x in shapes), *(bf16(ssm, sargs, x) for x in shapes)],
                   [*(bf16(qwen, qargs, x) for x in shapes), bf16(qwen, qargs)],
                   [f32(qwen, qargs), bf16(ssm, sargs), f32(ssm, sargs)]],
                  [both("mixtral-8x7b"), [*both("whisper-base"), *(leaves(phi, x) for x in shapes)],
                   [*both("stablelm-3b"), leaves(phi)]]]
        assert {a for a, _ in MESH_MORE} == {"mixtral-8x7b", "whisper-base",
                                              "phi-3-vision-4.2b", "stablelm-3b"}

        def lane(jobs):
            for key, argv, dtype, mesh, env in jobs:
                runs[key] = _launcher_run(tmp, key.replace(" ", "-"), argv, dtype, mesh,
                                          env_extra=env)

        def stage(lanes):
            with ThreadPoolExecutor(len(lanes)) as pool:
                for done in [pool.submit(lane, jobs) for jobs in lanes]:
                    done.result()

        steps = int(MESH_ARGS[MESH_ARGS.index("--steps") + 1])

        def check(arch, args):
            checks = []
            cfg32 = dataclasses.replace(get_config(arch), num_layers=int(
                args[args.index("--layers") + 1]), dtype="float32")
            if arch in (qwen, ssm):
                # whole leaves from the checkpoints of the last step (the
                # resume adds a later one)
                want = _ckpt_params(tmp / f"ck-{arch}-one", steps)
                start = _initial_params(cfg32, seed)
            else:
                # each leaf's samples, and its bytes' hash (mesh_rank_main)
                base = torch.load(runs[f"{arch} one f32"]["dir"] / "leaves.pt")
                want = {k: v for k, (_, v) in base.items()}
                start = _initial_samples(cfg32, seed)
            assert start.keys() == want.keys()
            for d, m in shapes:
                if arch in (qwen, ssm):
                    got = _ckpt_params(tmp / f"ck-{arch}-{d}x{m}", steps)
                    same = got.keys() == want.keys() and all(
                        torch.equal(got[k], want[k]) for k in want)
                    kept = "every leaf"
                else:
                    mine = torch.load(runs[f"{arch} {d}x{m} f32"]["dir"] / "leaves.pt")
                    got = {k: v for k, (_, v) in mine.items()}
                    same = {k: h for k, (h, _) in mine.items()} == {
                        k: h for k, (h, _) in base.items()}
                    kept = f"the bytes of every leaf; each leaf at up to {MESH_SAMPLES:,} entries"
                one = _check_f32(runs, arch, (d, m), cfg32, card, (got, want, start),
                                 same, steps, kept)
                if arch in (qwen, ssm):
                    one.update(_check_bf16(runs, arch, (d, m), cfg32, card))
                checks.append(one)
            return checks

        def check_all(configs):
            return [c for arch, args in configs for c in check(arch, args)]

        stage(stages[0])
        with ThreadPoolExecutor(1) as side:
            early = side.submit(check_all, MESH_MODELS)
            stage(stages[1])
            checks = early.result()
        checks += check_all(MESH_MORE)
        # qwen's first mesh's checkpoint resumed by one process (phase 20 (f))
        resume = runs.pop("resume")
        assert resume["lines"][0] == "resumed from step 3", resume["lines"]
        assert [h["step"] for h in resume["history"]] == [3], resume["history"]
        report.update(checks=checks, resume_lines=resume["lines"],
                      runs={k: dict(wall_s=v["wall_s"], lines=v["lines"],
                                    peak=[x["peak_bytes"] for x in v["ranks"]],
                                    step_ms=[x["step_ms"] for x in v["ranks"]])
                            for k, v in runs.items()})
    return report


def _check_f32(runs, arch, mesh, cfg32, card, leaves, same, steps, kept) -> dict:
    """A float32 mesh run against the one-process run: the losses within
    ``MESH_LOSS_TOL``, the gradient norms within it relative; of
    ``leaves`` = (the mesh's, the one process's, the initial), each
    parameter leaf's values after ``steps`` (what ``kept`` says of them)
    within ``MESH_PARAM_TOL`` of the one-process run's, and its gap within
    ``MESH_MOVE_TOL`` of that run's own change from the initial; a 1 x 1
    mesh is one process bit for bit (the histories, and ``same``: every
    leaf); each rank's allocation against ``cell_memory``."""
    d, m = mesh
    tag = f"{arch} {d}x{m}"
    r, base = runs[f"{tag} f32"], runs[f"{arch} one f32"]
    losses = [h["loss"] for h in r["history"]]
    base_losses = [h["loss"] for h in base["history"]]
    loss_err = max(abs(a - b) for a, b in zip(losses, base_losses))
    norms = [h["grad_norm"] for h in r["history"]]
    base_norms = [h["grad_norm"] for h in base["history"]]
    norm_err = max(abs(a - b) / b for a, b in zip(norms, base_norms))
    got, want, start = leaves
    assert got.keys() == want.keys()
    param_err = max((got[k] - want[k]).abs().max().item() for k in want)
    moved, worst = _moved_share(got, want, start)

    def metrics(run):
        return [{k: v for k, v in h.items() if k != "elapsed_s"} for h in run["history"]]

    exact = metrics(r) == metrics(base) and same
    log(f"  {tag}: float32 losses {losses} against one process {base_losses}: "
        f"{loss_err:.2e}; gradient norms {norm_err:.2e} apart (bars {MESH_LOSS_TOL}); "
        f"parameters after {steps} steps {param_err:.2e} (bar {MESH_PARAM_TOL}), the "
        f"worst leaf's gap {moved:.2e} of the one-process run's own change ({worst}; bar "
        f"{MESH_MOVE_TOL}, unmoved parameters read 1; compared: {kept}); bit for bit one "
        f"process (histories and every leaf): {exact}")
    assert len(losses) == len(base_losses) == steps and loss_err <= MESH_LOSS_TOL, (
        tag, losses, base_losses)
    assert norm_err <= MESH_LOSS_TOL, (tag, norms, base_norms)
    assert param_err <= MESH_PARAM_TOL, (tag, param_err)
    assert moved <= MESH_MOVE_TOL, (tag, moved, worst)
    assert exact or (d, m) != (1, 1), (tag, "a 1 x 1 mesh is not one process bit for bit")
    return dict(arch=arch, mesh=f"{d}x{m}", loss_err=loss_err, grad_norm_err=norm_err,
                param_err=param_err, moved_share=moved, moved_worst=worst,
                bit_for_bit=exact, memory=_check_memory(r, cfg32, card))


def _check_bf16(runs, arch, mesh, cfg32, card) -> dict:
    """A bf16 mesh run's losses against the one-process bf16 run's within
    ``MESH_BF16_TOL``; each rank's allocation against ``cell_memory``."""
    import dataclasses

    tag = f"{arch} {mesh[0]}x{mesh[1]}"
    r16 = runs[f"{tag} bf16"]
    losses16 = [h["loss"] for h in r16["history"]]
    base16 = [h["loss"] for h in runs[f"{arch} one bf16"]["history"]]
    bf16_err = max(abs(a - b) for a, b in zip(losses16, base16))
    log(f"  {tag}: bf16 losses {losses16} against one process {base16}: {bf16_err:.2e} "
        f"(bar {MESH_BF16_TOL}); the same: {losses16 == base16}")
    assert len(losses16) == len(base16) and bf16_err <= MESH_BF16_TOL, (tag, bf16_err)
    return dict(bf16_loss_err=bf16_err, bf16_same=losses16 == base16,
                memory_bf16=_check_memory(r16, dataclasses.replace(cfg32, dtype="bfloat16"),
                                          card))


def drive_mesh_full(card, scratch) -> dict:
    """Phase 22 (b): with 4 cards or more, full width in bf16 (full depth
    but where ``MESH_FULL`` cuts it)."""
    import dataclasses

    from repro_torch.configs import get_config

    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        log(f"phase 22 (b): left out: {n_cards} card(s) visible; "
            + ", ".join(f"{a} on {d} x {m}" for a, (d, m), _, _ in MESH_FULL) + " need 4")
        return {"left_out": f"{n_cards} card(s)"}
    out = []
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for arch, (d, m), layers, extra in MESH_FULL:
            cfg = get_config(arch)
            argv = ["--arch", arch, *(["--layers", str(layers)] if layers else []),
                    *MESH_FULL_ARGS, *extra]
            r = _launcher_run(Path(tmp), f"{arch}-{d}x{m}", argv, cfg.dtype, (d, m))
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            out.append(dict(arch=arch, mesh=f"{d}x{m}", layers=cfg.num_layers,
                            lines=r["lines"], history=r["history"],
                            memory=_check_memory(r, cfg, card)))
    return {"runs": out}


def drive_phase22(card, scratch) -> dict:
    """Phase 22: (a) on one card or more, (b) with four cards or more."""
    t22 = time.perf_counter()
    report = {"a": drive_mesh_train(card, scratch), "b": drive_mesh_full(card, scratch)}
    report["phase_s"] = time.perf_counter() - t22
    log(f"phase 22: {report['phase_s']:.1f} s")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the package is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. the card
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(cached={_build.build_info.get('cached')}) -> {_build.build_info['path']}")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")

    # 3. kernels against their plain versions
    check_kernels_at_shapes(dev)

    # 4-6. the main path per matrix
    clock = Clock(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    entries = []
    for name, want_k1, want_k2, want_k3 in MATRICES:
        report, rec, g, ge = drive_matrix(dev, clock, name, want_k1, want_k2,
                                          want_k3)
        ents = kernel_entries(dev, clock, rec, report)
        report["kernels"] = ents
        report["profile"] = profile_path(dev, clock, g, ge)
        # K1 runs once per run, K2 and K3 once per dense group: the eager
        # factorization's count of their device kernels over their launches
        # is kernels per call
        fact = report["profile"]["eager_factorize"]
        for e in ents:
            key = ("level_run_kernels" if e["name"] == "level_run"
                   else "dense_lu_kernels")
            e["device_kernels_per_call"] = fact[key] / e["launches"]
        entries += ents
        log(json.dumps({"matrix_report": report}))
        del rec, g, ge

    # 7. static pivoting, real and complex
    pivot_report, robust = drive_static_pivot(dev, clock)
    entries.append(robust)
    log(json.dumps({"static_pivot_report": pivot_report}))
    pivot_report, robust = drive_complex_static_pivot(dev, clock)
    entries.append(robust)
    log(json.dumps({"complex_static_pivot_report": pivot_report}))

    # 8. the Newton transient
    log(json.dumps({"transient_report": drive_transient(dev)}))

    # 9-10. the batched engine: grid64 and rajat12_like at B = 1 and 16,
    # rajat12_ac at B = 8 frequencies
    for name, want_k1, want_k2, want_k3 in MATRICES:
        reports, rec, ent_report = drive_batched(dev, clock, name, want_k1,
                                                 want_k2, want_k3)
        ents = kernel_entries(dev, clock, rec, ent_report)
        for e in ents:       # device kernels per launch, as in phase 6
            key = ("level_run_kernels" if e["name"].startswith("level_run")
                   else "dense_lu_kernels")
            e["device_kernels_per_call"] = (ent_report["eager_profile"][key]
                                            / e["launches"])
        entries += ents
        log(json.dumps({"batched_report": reports}))
        del rec

    # 11. static pivoting on a batch
    pivot_report, robust = drive_batched_static_pivot(dev, clock)
    entries.append(robust)
    log(json.dumps({"batched_static_pivot_report": pivot_report}))

    # 12. the lockstep transient sweep
    log(json.dumps({"sweep_report": drive_sweep(dev)}))

    # 13. pruned and many-RHS solves
    for name, _, _, _ in MATRICES:
        log(json.dumps({"pattern_report": drive_patterns(dev, clock, card,
                                                          name)}))

    # 14. the AC sweep
    ac_report, robust = drive_ac_sweep(dev, clock, card)
    entries.append(robust)
    log(json.dumps({"ac_sweep_report": ac_report}))

    # 15. dependency detection (host), the mode ablation and GLU(verify=
    # "full") on the card
    log(json.dumps({"detection_report": [drive_detection(name)
                                         for name in PHASE15_MATRICES]}))
    for name in PHASE15_MATRICES:
        modes_report, noflat = drive_modes(dev, clock, card, name)
        if noflat is not None:
            entries.append(noflat)
        log(json.dumps({"modes_report": modes_report}))
    assert any(e.get("variant") == "noflat" for e in entries)
    log(json.dumps({"verify_report": [drive_verify(dev, name)
                                      for name in PHASE15_MATRICES]}))

    # 16. sharded sweeps, Matrix Market, the on-disk plan cache, the
    # multi-domain chip, the left-looking baseline and the CLIs
    log(json.dumps({"sharded_report": drive_sharded(dev, clock, card)}))
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        log(json.dumps({"matrix_market_report": drive_matrix_market(tmp)}))
        log(json.dumps({"plan_cache_report": drive_plan_cache(tmp)}))
    log(json.dumps({"multi_domain_report": drive_multi_domain(dev, clock)}))
    log(json.dumps({"leftlooking_report": drive_leftlooking()}))
    # the entry points in processes of their own, all at once: the
    # simulator's CLI (16 (f)), the serving CLI of phases 17-19 and phase
    # 21 (a)'s dry-run sweep (host only); each is judged in its phase
    dry = tempfile.TemporaryDirectory(dir=scratch)
    serve_cli_args = [LM_CLI_ARGS, MOE_CLI_ARGS, *SSM_CLI_ARGS]
    t0 = time.perf_counter()
    results = run_at_once([cli_cmd("repro_torch.launch.simulate", CLI_ARGS),
                           *(cli_cmd("repro_torch.launch.serve", a) for a in serve_cli_args),
                           *dryrun_cmds(dry.name)])
    log(f"the CLIs and the dry-run sweep: {len(results)} processes at once, "
        f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps({"cli_report": drive_cli(results[0])}))
    serve_clis = results[1:1 + len(serve_cli_args)]
    sweep = drive_dryrun_sweep(dry.name, results[1 + len(serve_cli_args):])
    dry.cleanup()

    log(f"peak device memory (phases 4-16): "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")

    # 23. complex values in the native layout: rajat12_ac single and
    # batched, the AC sweep (rajat12's plan still in the process's cache)
    log(json.dumps({"native_report": drive_native(dev, clock, card)}))

    # 24. the six examples on the card at their defaults
    t24 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        examples = drive_examples(tmp)
    log(f"phase 24: {time.perf_counter() - t24:.1f} s")
    log(json.dumps({"examples_report": examples}))

    # 17. the LM serving path: qwen2.5-3b at full width (bf16), float32
    # against the full-sequence pass, the request scheduler, card against
    # CPU, the vlm and audio families, the CLI
    t17 = time.perf_counter()
    serve_report, engine = drive_lm_serve(dev, card)
    serve_report["forced"] = drive_lm_forced(dev)
    serve_report["requests"] = drive_lm_requests(engine)
    del engine
    torch.cuda.empty_cache()
    serve_report["cpu_card"] = drive_lm_cpu_card(dev)
    serve_report["others"] = drive_lm_others(dev, card)
    serve_report["cli"] = drive_serve_cli(LM_CLI_ARGS, serve_clis[0])
    serve_report["phase_s"] = time.perf_counter() - t17
    log(json.dumps({"lm_serve_report": serve_report}))

    # 18. MLA and the sort-based MoE: deepseek-v2-lite-16b at full width
    # and depth (bf16), its forced and float32 checks, card against CPU
    # with drops, mixtral-8x7b at full width and 8 layers, the CLI
    t18 = time.perf_counter()
    moe_report, prompts = drive_moe_serve(dev, card)
    moe_report["forced"] = drive_moe_forced(dev, prompts)
    moe_report["float32"] = drive_moe_f32(dev)
    moe_report["cpu_card"] = drive_moe_cpu_card(dev)
    moe_report["mixtral"] = drive_mixtral(dev, card)
    moe_report["cli"] = drive_serve_cli(MOE_CLI_ARGS, serve_clis[1])
    moe_report["phase_s"] = time.perf_counter() - t18
    log(f"phase 18: {moe_report['phase_s']:.1f} s")
    log(json.dumps({"moe_serve_report": moe_report}))

    # 19. the Mamba-2 (SSD) block: mamba2-2.7b at full width and 32 layers
    # (bf16), its bf16 and float32 forced checks with planted faults, card
    # against CPU, jamba-v0.1-52b at full width and one 8-layer period,
    # the CLI
    t19 = time.perf_counter()
    ssm_report, model, prompts = drive_ssm_serve(dev, card)
    ssm_report["forced"] = drive_ssm_forced(dev, model, prompts)
    del model
    torch.cuda.empty_cache()
    ssm_report["float32"] = drive_ssm_f32(dev)
    ssm_report["cpu_card"] = drive_ssm_cpu_card(dev)
    ssm_report["scan"] = drive_ssd_scan(dev)
    ssm_report["jamba"] = drive_jamba(dev, card)
    ssm_report["cli"] = [drive_serve_cli(a, r)
                         for a, r in zip(SSM_CLI_ARGS, serve_clis[2:])]
    ssm_report["phase_s"] = time.perf_counter() - t19
    log(f"phase 19: {ssm_report['phase_s']:.1f} s")
    log(json.dumps({"ssm_serve_report": ssm_report}))

    # 20. the training path: qwen2.5-3b at full width and 6 layers (bf16,
    # AdamW) with a checkpoint and a bit-for-bit resume, reduced configs
    # card against CPU, float32 gradients against central differences,
    # mamba2-2.7b's SSD backward, the launcher and its resume
    train_report = drive_phase20(dev, card, scratch)
    log(json.dumps({"train_report": train_report}))

    # 21. the dry run: every arch's train_4k and decode_32k cell on the
    # 16x16 mesh (fake process groups, fake tensors; its processes ran
    # beside phase 16's CLIs), and phase 20's step
    # as a cell on a 1 x 1 mesh held against the card's allocation
    log(json.dumps({"dryrun_report": drive_phase21(card, train_report, sweep)}))

    # 22. the training step on a mesh of ranks under the reference's
    # rules: qwen2.5-3b and mamba2-2.7b (4 layers each), whisper-base,
    # phi-3-vision-4.2b, stablelm-3b and mixtral-8x7b through the launcher
    # under torch.distributed.run against one process, each rank's
    # allocation against cell_memory, the resume; with 4 cards the configs
    # at full width in bf16 on 2 x 2 (and 4 x 1); the launcher runs' lanes
    # share the card with what this process keeps cached
    torch.cuda.empty_cache()
    log(json.dumps({"mesh_train_report": drive_phase22(card, scratch)}))

    names = {e["name"] for e in entries}
    assert names == {"level_run", "level_run_robust", "dense_lu",
                     "dense_lu_planar", "level_run_batched",
                     "level_run_robust_batched", "dense_lu_batched",
                     "dense_lu_planar_batched"}, names
    robust_kinds = {(e["name"], e["dtype"]) for e in entries
                    if e["name"].startswith("level_run_robust")}
    assert robust_kinds == {(k, d) for k in ("level_run_robust",
                                             "level_run_robust_batched")
                            for d in ("torch.float64", "torch.complex128")}, \
        robust_kinds
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(f"card: {card}")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2], sys.argv[3], sys.argv[5:]))
    sys.exit(main())
