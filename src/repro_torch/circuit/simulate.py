"""Transient circuit simulation driver: the paper's end-to-end application.

Backward-Euler time stepping with Newton-Raphson at each step.  The GLU
symbolic plan is built ONCE; every Newton iterate only refactorizes new
values on the fixed pattern — the workload GLU3.0 accelerates ("the
numeric factorization on GPU might be repeated many times when solving a
nonlinear equation with Newton-Raphson method").  On the card each
refactorization is one CUDA-graph replay, and so is each solve (a refined
solve: one replay for the solve and one per chunk of refinement sweeps);
per iterate the host assembles values and right-hand side in numpy, copies
them to the card and reads the solution back.

Degraded factorizations are handled by the adaptive refactorization ladder
(:mod:`.ladder`): the driver escalates refactorize -> re-scale ->
static-pivot bump -> full replan, climbing only as far as the diagnostics
demand (``escalation="rescale"`` selects the single-rebuild behaviour,
``"none"`` disables recovery).  Rebuilds construct a fresh ``GLU`` on the
same pattern, so the re-scale and bump rungs are plan-cache hits
(``plan_cache_hits``); only the replan rung bypasses the cache.

``transient_sweep`` steps B perturbed copies of one circuit in lockstep on
one plan (the Monte-Carlo / process-corner workload): per Newton iterate
the host assembles the B systems, and one ``GLU.refactorize_solve``
factorizes and solves them together (on the card one replay each for the
batched factorization and solve).

``ac_sweep`` is SPICE's AC small-signal analysis: the DC operating point by
the same Newton loop and ladder, then ``A(w) = G + jwC`` at every frequency
point factorized and solved in lockstep on one complex128 plan, one
batched ``refactorize_solve`` whose initial solves are pruned to the reach
of the AC sources' nodes.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..core.api import GLU
from ..core.factorize import ported_layout
from ..distributed import check_mesh
from ..sparse.csc import CSC
from .ladder import RUNGS, LadderConfig, RefactorizationLadder
from .mna import Circuit

__all__ = ["ACSweepResult", "TransientResult", "TransientSweepResult",
           "ac_sweep", "transient", "transient_sweep", "perturbed_copies",
           "A_mul"]


def _empty_ladder_counts() -> dict:
    return {name: 0 for name in RUNGS}


def _make_ladder(escalation, config: Optional[LadderConfig]):
    if escalation == "ladder":
        return RefactorizationLadder(config)
    if escalation in ("rescale", "none"):
        return None
    raise ValueError(
        f"escalation must be 'ladder', 'rescale' or 'none', got {escalation!r}")


def _worst_index(glu) -> int:
    """Representative copy of a batched factorization for a rebuild: worst
    backward error when refinement ran, else worst pivot growth."""
    info = glu.solve_info or {}
    for key in ("backward_error", "pivot_growth"):
        v = info.get(key)
        if v is not None and np.ndim(v) > 0:
            a = np.asarray(v, dtype=np.float64)
            a = np.where(np.isfinite(a), a, np.inf)
            return int(np.argmax(a))
    return 0


@dataclasses.dataclass
class TransientResult:
    times: np.ndarray           # (T,)
    voltages: np.ndarray        # (T, n)
    newton_iters: np.ndarray    # (T,)
    n_factorizations: int
    setup_seconds: float
    solve_seconds: float
    max_residual: float
    n_rescalings: int = 0       # cache-served scaling rebuilds (rescale/bump rungs)
    plan_cache_hits: int = 0    # GLU constructions served by the plan cache
    n_full_rebuilds: int = 0    # ALL ladder-triggered rebuilds (rungs 1-3)
    ladder_counts: Optional[dict] = None  # per-rung action counts


def A_mul(pat, vals: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y = A @ x for values on the circuit pattern (host-side check)."""
    y = np.zeros(pat.n, dtype=np.result_type(vals.dtype, x.dtype, np.float64))
    cols = np.repeat(np.arange(pat.n), np.diff(pat.indptr))
    np.add.at(y, pat.indices, vals * x[cols])
    return y


def transient(
    ckt: Circuit,
    t_end: float,
    dt: float,
    newton_tol: float = 1e-9,
    max_newton: int = 25,
    ordering: str = "auto",
    dtype=None,
    glu: Optional[GLU] = None,
    refine: Optional[int] = None,
    refine_tol: Optional[float] = None,
    static_pivot: Optional[float] = None,
    mc64="scale",
    escalation: str = "ladder",
    ladder_config: Optional[LadderConfig] = None,
    jit_schedule: bool = True,
    device=None,
) -> TransientResult:
    """Backward-Euler + Newton transient.  ``refine=None`` (default) leaves
    a prebuilt ``glu``'s own refinement default in charge; an explicit
    integer — including 0 — overrides it per solve.

    ``device``: ``None`` runs on the card (and raises when there is none),
    ``"cpu"`` runs the kernels' plain PyTorch versions; ``jit_schedule``
    is the ``GLU`` option (one CUDA-graph replay per factorization and per
    solve on the card).  ``dtype`` defaults to ``torch.float64``.

    ``escalation`` selects the recovery policy consulted after every linear
    solve (only when this driver constructed the GLU itself — a
    caller-supplied ``glu`` is never swapped out):

    * ``"ladder"`` (default): the adaptive ladder of :mod:`.ladder` — on an
      unhealthy diagnosis (stalled refinement, non-finite solution, or
      excessive pivot growth when refinement is off) escalate re-scale ->
      static-pivot bump -> full replan, one rung per retry; the rung is
      sticky across the run and at most one top-rung retry fires per time
      step.  Per-rung counts land in ``ladder_counts``; ``n_rescalings``
      counts the cache-served scaling rebuilds and ``n_full_rebuilds`` all
      ladder-triggered rebuilds.
    * ``"rescale"``: one MC64 re-scaling rebuild per time step when
      refinement reports non-convergence (requires ``refine > 0``).
    * ``"none"``: never rebuild.
    """
    dtype = dtype or torch.float64
    pat = ckt.pattern()
    n = ckt.n

    t0 = time.perf_counter()
    v = np.zeros(n)
    vals0, _ = ckt.assemble(v, v, dt, 0.0)

    A0 = CSC(pat.n, pat.indptr, pat.indices, vals0)
    glu_kwargs = dict(ordering=ordering, dtype=dtype, refine=refine or 0,
                      refine_tol=refine_tol, static_pivot=static_pivot,
                      mc64=mc64, jit_schedule=jit_schedule, device=device)
    ladder = _make_ladder(escalation, ladder_config)
    # re-scaling rebuilds only apply to a GLU this driver constructed: a
    # caller-prebuilt solver may carry configuration (dense_tail, custom
    # tolerances, ...) that glu_kwargs cannot reproduce, so it is never
    # silently swapped out mid-run
    owns_glu = glu is None
    n_plan_hits = 0
    if owns_glu:
        glu = GLU(A0, **glu_kwargs)
        n_plan_hits += int(glu.plan_from_cache)
    setup_s = time.perf_counter() - t0

    steps = int(round(t_end / dt))
    times = np.arange(1, steps + 1) * dt
    volts = np.zeros((steps, n))
    iters = np.zeros(steps, dtype=np.int64)
    n_fact = 0
    n_rescale = 0
    max_res = 0.0

    t0 = time.perf_counter()
    v_prev = v.copy()
    for s, t in enumerate(times):
        v_it = v_prev.copy()
        rescaled_this_step = False
        for it in range(max_newton):
            vals, rhs = ckt.assemble(v_it, v_prev, dt, float(t))
            glu.factorize(vals)
            n_fact += 1
            if ladder is not None:
                ladder.note_refactorize()
            # an explicit refine (including 0) wins over a prebuilt glu's
            # own default; None defers to it
            v_new = (glu.solve(rhs) if refine is None
                     else glu.solve(rhs, refine=refine))
            if ladder is not None and owns_glu:
                # escalation ladder: climb one rung per retry while the
                # diagnosis stays unhealthy.  The rung is sticky across the
                # run; once at the top, at most one fresh-values retry per
                # time step (the Newton dv test remains the step's arbiter).
                # A numerically singular iterate (a device switched fully
                # off) aborts the climb instead of crashing the run.
                reason = ladder.diagnose(glu, v_new)
                while reason is not None:
                    if ladder.can_escalate():
                        ladder.escalate(step=s, reason=reason)
                    elif not rescaled_this_step:
                        ladder.retry_at_current_rung(step=s, reason=reason)
                    else:
                        break
                    rescaled_this_step = True
                    try:
                        glu = GLU(CSC(pat.n, pat.indptr, pat.indices, vals),
                                  **ladder.glu_kwargs(glu_kwargs))
                    except ValueError:
                        break
                    n_plan_hits += int(glu.plan_from_cache)
                    glu.factorize(vals)
                    n_fact += 1
                    v_new = (glu.solve(rhs) if refine is None
                             else glu.solve(rhs, refine=refine))
                    reason = ladder.diagnose(glu, v_new)
            elif (escalation == "rescale" and refine and owns_glu
                    and not rescaled_this_step):
                # a cheap flag read: it forces none of solve_info's
                # deferred reductions.  Refinement stalled: the setup-time
                # scaling no longer fits this operating point, so re-run
                # MC64 on the current Jacobian and retry the solve, at most
                # once per time step; a Jacobian that is numerically
                # singular at this iterate skips the rebuild
                if glu.refine_converged is False:
                    rescaled_this_step = True
                    try:
                        glu = GLU(CSC(pat.n, pat.indptr, pat.indices, vals),
                                  **glu_kwargs)
                    except ValueError:
                        pass
                    else:
                        n_rescale += 1
                        n_plan_hits += int(glu.plan_from_cache)
                        glu.factorize(vals)
                        n_fact += 1
                        v_new = glu.solve(rhs)
            dv = np.abs(v_new - v_it).max()
            v_it = v_new
            if dv < newton_tol:
                break
        iters[s] = it + 1
        # final residual check at the converged point
        vals, rhs = ckt.assemble(v_it, v_prev, dt, float(t))
        r = np.abs(A_mul(pat, vals, v_it) - rhs).max()
        max_res = max(max_res, float(r))
        volts[s] = v_it
        v_prev = v_it
    solve_s = time.perf_counter() - t0

    counts = _empty_ladder_counts() if ladder is None else dict(ladder.counts)
    if ladder is not None:
        n_rescale = counts["rescale"] + counts["bump"]
    return TransientResult(
        times=times,
        voltages=volts,
        newton_iters=iters,
        n_factorizations=n_fact,
        setup_seconds=setup_s,
        solve_seconds=solve_s,
        max_residual=max_res,
        n_rescalings=n_rescale,
        plan_cache_hits=n_plan_hits,
        n_full_rebuilds=0 if ladder is None else ladder.n_full_rebuilds,
        ladder_counts=counts,
    )


@dataclasses.dataclass
class TransientSweepResult:
    scales: np.ndarray          # (B,) parameter perturbation factors
    times: np.ndarray           # (T,)
    voltages: np.ndarray        # (B, T, n)
    newton_iters: np.ndarray    # (T,) lockstep iterations per time step
    n_batched_factorizations: int
    setup_seconds: float
    solve_seconds: float
    max_residual: float         # worst over sweep copies and time steps
    n_rescalings: int = 0       # cache-served scaling rebuilds (rescale/bump rungs)
    plan_cache_hits: int = 0    # GLU constructions served by the plan cache
    n_full_rebuilds: int = 0    # ALL ladder-triggered rebuilds (rungs 1-3)
    ladder_counts: Optional[dict] = None  # per-rung action counts
    n_devices: int = 1          # devices the batch ran on


def perturbed_copies(ckt: Circuit, scales) -> list:
    """One circuit per scale factor: all conductances and capacitances
    multiplied by ``s`` (a global process-corner perturbation).  Topology is
    unchanged, so every copy shares the same sparsity pattern, and hence
    one GLU symbolic plan."""
    out = []
    for s in np.asarray(scales, dtype=np.float64):
        c = Circuit(ckt.n_nodes)
        c.resistors = [(a, b, g * s) for a, b, g in ckt.resistors]
        c.capacitors = [(a, b, cap * s) for a, b, cap in ckt.capacitors]
        c.isources = list(ckt.isources)
        c.ac_isources = list(ckt.ac_isources)
        c.diodes = list(ckt.diodes)
        out.append(c)
    return out


def transient_sweep(
    ckt: Circuit,
    t_end: float,
    dt: float,
    scales,
    newton_tol: float = 1e-9,
    max_newton: int = 25,
    ordering: str = "auto",
    dtype=None,
    refine: Optional[int] = None,
    refine_tol: Optional[float] = None,
    static_pivot: Optional[float] = None,
    mc64="scale",
    escalation: str = "ladder",
    ladder_config: Optional[LadderConfig] = None,
    mesh=None,
    jit_schedule: bool = True,
    device=None,
) -> TransientSweepResult:
    """Run B parameter-perturbed copies of ``ckt`` through backward-Euler +
    Newton in lockstep on one symbolic plan (the Monte-Carlo / corner-sweep
    workload: same pattern, many value vectors per Newton iterate).

    Each iterate assembles the B Jacobians on the host, then one
    ``GLU.refactorize_solve`` factorizes and solves the whole batch on the
    device.  A per-scenario convergence mask freezes each copy once its
    Newton update drops below ``newton_tol``: its Jacobian is no longer
    assembled and its iterate no longer changes, while the batch still
    solves as one call until every copy has converged.

    ``escalation`` follows :func:`transient`: the default ``"ladder"``
    climbs re-scale -> bump -> replan on unhealthy diagnostics, with the
    worst copy of the batch as the rebuild's scaling representative (one
    shared plan, so one representative picks the scaling).  ``device`` and
    ``jit_schedule`` are as in :func:`transient`.  ``mesh`` (a
    :class:`~repro_torch.distributed.SweepMesh`) shards the batch of every
    ``refactorize_solve`` over the mesh's devices (see ``GLU``'s
    ``mesh``); the voltages are the unsharded sweep's bit for bit and
    ``n_devices`` says how many devices the batch ran on.
    """
    dtype = dtype or torch.float64
    scales = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    ckts = perturbed_copies(ckt, scales)
    B = len(ckts)
    pat = ckts[0].pattern()
    n = ckt.n

    t0 = time.perf_counter()
    v0 = np.zeros(n)
    vals0, _ = ckts[0].assemble(v0, v0, dt, 0.0)
    glu_kwargs = dict(ordering=ordering, dtype=dtype, refine=refine or 0,
                      refine_tol=refine_tol, static_pivot=static_pivot,
                      mc64=mc64, jit_schedule=jit_schedule, device=device,
                      mesh=mesh)
    ladder = _make_ladder(escalation, ladder_config)
    glu = GLU(CSC(pat.n, pat.indptr, pat.indices, vals0), **glu_kwargs)
    n_plan_hits = int(glu.plan_from_cache)
    setup_s = time.perf_counter() - t0

    steps = int(round(t_end / dt))
    times = np.arange(1, steps + 1) * dt
    volts = np.zeros((B, steps, n))
    iters = np.zeros(steps, dtype=np.int64)
    n_fact = 0
    n_rescale = 0
    max_res = 0.0

    def assemble_all(v_it, v_prev, t):
        vals = np.empty((B, pat.nnz))
        rhs = np.empty((B, n))
        for k, c in enumerate(ckts):
            vals[k], rhs[k] = c.assemble(v_it[k], v_prev[k], dt, t)
        return vals, rhs

    t0 = time.perf_counter()
    v_prev = np.zeros((B, n))
    for s, t in enumerate(times):
        v_it = v_prev.copy()
        rescaled_this_step = False
        active = np.ones(B, dtype=bool)
        for it in range(max_newton):
            if it == 0:
                vals, rhs = assemble_all(v_it, v_prev, float(t))
            else:
                for k in np.flatnonzero(active):
                    vals[k], rhs[k] = ckts[k].assemble(
                        v_it[k], v_prev[k], dt, float(t))
            v_new = glu.refactorize_solve(vals, rhs)
            n_fact += 1
            if ladder is not None:
                ladder.note_refactorize()
                # the climb of ``transient``; the rebuild's scaling
                # representative is the worst copy of the batch
                reason = ladder.diagnose(glu, v_new)
                while reason is not None:
                    if ladder.can_escalate():
                        ladder.escalate(step=s, reason=reason)
                    elif not rescaled_this_step:
                        ladder.retry_at_current_rung(step=s, reason=reason)
                    else:
                        break
                    rescaled_this_step = True
                    worst = _worst_index(glu)
                    try:
                        glu = GLU(CSC(pat.n, pat.indptr, pat.indices,
                                      vals[worst]),
                                  **ladder.glu_kwargs(glu_kwargs))
                    except ValueError:
                        break
                    n_plan_hits += int(glu.plan_from_cache)
                    v_new = glu.refactorize_solve(vals, rhs)
                    n_fact += 1
                    reason = ladder.diagnose(glu, v_new)
            elif escalation == "rescale" and refine and not rescaled_this_step:
                # a cheap flag read per iterate; the full solve_info (with
                # its deferred device reductions) only on the rebuild path:
                # re-scale on the worst copy's Jacobian, at most once per
                # time step, as ``transient`` does
                conv = glu.refine_converged
                if conv is not None and not np.asarray(conv).all():
                    info = glu.solve_info
                    worst = int(np.argmax(np.asarray(info["backward_error"])))
                    rescaled_this_step = True
                    try:
                        glu = GLU(CSC(pat.n, pat.indptr, pat.indices,
                                      vals[worst]), **glu_kwargs)
                    except ValueError:
                        pass
                    else:
                        n_rescale += 1
                        n_plan_hits += int(glu.plan_from_cache)
                        v_new = glu.refactorize_solve(vals, rhs)
                        n_fact += 1
            v_new = np.where(active[:, None], v_new, v_it)
            dv_rows = np.abs(v_new - v_it).max(axis=1)
            v_it = v_new
            active &= dv_rows >= newton_tol
            if not active.any():
                break
        iters[s] = it + 1
        vals, rhs = assemble_all(v_it, v_prev, float(t))
        for k in range(B):
            r = np.abs(A_mul(pat, vals[k], v_it[k]) - rhs[k]).max()
            max_res = max(max_res, float(r))
        volts[:, s] = v_it
        v_prev = v_it
    solve_s = time.perf_counter() - t0

    counts = _empty_ladder_counts() if ladder is None else dict(ladder.counts)
    if ladder is not None:
        n_rescale = counts["rescale"] + counts["bump"]
    return TransientSweepResult(
        scales=scales,
        times=times,
        voltages=volts,
        newton_iters=iters,
        n_batched_factorizations=n_fact,
        setup_seconds=setup_s,
        solve_seconds=solve_s,
        max_residual=max_res,
        n_rescalings=n_rescale,
        plan_cache_hits=n_plan_hits,
        n_full_rebuilds=0 if ladder is None else ladder.n_full_rebuilds,
        ladder_counts=counts,
        n_devices=glu.n_devices if B > 1 else 1,
    )


# --------------------------------------------------------------------------
# AC small-signal analysis
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ACSweepResult:
    freqs: np.ndarray            # (F,) sweep frequencies in Hz
    voltages: np.ndarray         # (F, n) complex node-voltage phasors
    op_point: np.ndarray         # (n,) DC operating point the sweep linearized at
    op_newton_iters: int         # Newton iterations spent finding it
    n_batched_factorizations: int  # batched complex factorize+solve calls (1)
    setup_seconds: float         # operating point + symbolic plan
    solve_seconds: float         # the batched complex linear solve
    max_backward_error: float    # worst componentwise berr over all freqs
    plan_cache_hits: int = 0     # GLU constructions served by the plan cache
    op_converged: bool = True    # DC operating-point Newton loop met newton_tol
    n_full_rebuilds: int = 0     # ladder-triggered rebuilds (DC + AC phases)
    ladder_counts: Optional[dict] = None  # per-rung action counts
    n_devices: int = 1           # devices the frequency axis ran on


def ac_sweep(
    ckt: Circuit,
    freqs,
    newton_tol: float = 1e-9,
    max_newton: int = 50,
    ordering: str = "auto",
    refine: int = 2,
    refine_tol: Optional[float] = None,
    static_pivot: Optional[float] = None,
    mc64="scale",
    escalation: str = "ladder",
    ladder_config: Optional[LadderConfig] = None,
    layout: str = "auto",
    mesh=None,
    jit_schedule: bool = True,
    device=None,
) -> ACSweepResult:
    """AC small-signal frequency sweep: ``A(w) x(w) = b`` at every point.

    The classic second half of SPICE: find the DC operating point with the
    Newton loop of :func:`transient` (capacitors open, ``dt=0`` assembly),
    linearize there, then factorize ``A(w) = G + jwC`` for all F frequency
    points in lockstep: one complex128 symbolic plan, one batched
    ``refactorize_solve`` over the (F, nnz) value matrix (on the card one
    replay for the batched factorization, one batched K1 launch per run and
    one batched K3 launch for the F dense tails).

    Iterative refinement (default ``refine=2``) runs on the complex values
    (the componentwise backward error is written in terms of ``|.|``), and
    ``max_backward_error`` reports the worst frequency point on the
    original (unscaled) systems.

    The excitation is nonzero only at the AC current-source nodes, so the
    batched solve passes that support as ``rhs_pattern`` and the initial
    triangular solves run on the reach-pruned sweeps.  One escalation
    ladder (see :func:`transient`) is shared by the DC operating-point loop
    and the AC phase: a rung climbed while finding the operating point
    carries into the AC solver's construction, and an unhealthy AC solve
    rebuilds on the worst frequency point's values.  A non-converged
    operating-point loop sets ``op_converged=False`` and warns.

    ``layout``: the complex values' layout, ``"auto"`` (default, planar
    here) or ``"planar"``, on the kernels, or ``"native"``, the JAX
    package's default complex route: every level of the batched complex
    factorization a flat step, the dense tails on one batched K3 launch.
    A bad name raises before any work.  ``device`` and
    ``jit_schedule`` are as in :func:`transient`.  ``mesh`` shards the
    frequency axis of the batched AC refactorize/solve over the mesh's
    devices (see ``GLU``'s ``mesh``); the single-matrix DC operating-point
    loop stays unsharded on the mesh's first device.
    """
    if check_mesh(mesh) is not None and device is None:
        device = mesh.devices[0]
    ported_layout(layout, torch.complex128)
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    pat = ckt.pattern()
    n = ckt.n
    ladder = _make_ladder(escalation, ladder_config)

    t0 = time.perf_counter()
    # DC operating point: dt=0 assembly opens the capacitors; the AC
    # sources are zero at the operating point by definition
    v = np.zeros(n)
    glu_dc = None
    n_plan_hits = 0
    op_iters = 0
    dv = np.inf
    dc_kwargs = dict(ordering=ordering, dtype=torch.float64, refine=refine,
                     refine_tol=refine_tol, static_pivot=static_pivot,
                     mc64=mc64, jit_schedule=jit_schedule, device=device)
    rebuilt_dc = False
    for it in range(max_newton):
        vals, rhs = ckt.assemble(v, v, 0.0, 0.0)
        if glu_dc is None:
            # the operating-point solves get the AC phase's robustness
            # options: a bad operating point poisons the linearization
            glu_dc = GLU(CSC(pat.n, pat.indptr, pat.indices, vals),
                         **(dc_kwargs if ladder is None
                            else ladder.glu_kwargs(dc_kwargs)))
            n_plan_hits += int(glu_dc.plan_from_cache)
        glu_dc.factorize(vals)
        v_new = glu_dc.solve(rhs)
        if ladder is not None:
            ladder.note_refactorize()
            reason = ladder.diagnose(glu_dc, v_new)
            while reason is not None:
                if ladder.can_escalate():
                    ladder.escalate(step="dc-op", reason=reason)
                elif not rebuilt_dc:
                    ladder.retry_at_current_rung(step="dc-op", reason=reason)
                else:
                    break
                rebuilt_dc = True
                try:
                    glu_dc = GLU(CSC(pat.n, pat.indptr, pat.indices, vals),
                                 **ladder.glu_kwargs(dc_kwargs))
                except ValueError:
                    break
                n_plan_hits += int(glu_dc.plan_from_cache)
                glu_dc.factorize(vals)
                v_new = glu_dc.solve(rhs)
                reason = ladder.diagnose(glu_dc, v_new)
        dv = np.abs(v_new - v).max()
        v = v_new
        op_iters = it + 1
        if dv < newton_tol:
            break
    op_converged = bool(dv < newton_tol)
    if not op_converged:
        warnings.warn(
            f"ac_sweep: DC operating-point Newton loop did not converge in "
            f"{max_newton} iterations (last |dv| = {dv:.3g} >= newton_tol "
            f"= {newton_tol:.3g}); the sweep linearizes at an unconverged "
            f"operating point", RuntimeWarning, stacklevel=2)

    # the AC excitation's nonzero support: the pruned solves need b to be
    # exactly zero outside the pattern
    ac_nodes = sorted({node - 1 for a, b, _ in ckt.ac_isources
                       for node in (a, b) if node > 0})
    rhs_pattern = np.asarray(ac_nodes, dtype=np.int64) if ac_nodes else None

    # one complex plan for the whole sweep (MC64 matches/scales on |A(w0)|)
    vals_ac, rhs_ac = ckt.assemble_ac(v, freqs)
    ac_kwargs = dict(ordering=ordering, dtype=torch.complex128, refine=refine,
                     refine_tol=refine_tol, static_pivot=static_pivot,
                     mc64=mc64, layout=layout, jit_schedule=jit_schedule,
                     device=device, mesh=mesh)
    glu = GLU(CSC(pat.n, pat.indptr, pat.indices, vals_ac[0]),
              **(ac_kwargs if ladder is None else ladder.glu_kwargs(ac_kwargs)))
    n_plan_hits += int(glu.plan_from_cache)
    setup_s = time.perf_counter() - t0
    n_batched = 0

    t0 = time.perf_counter()
    x = glu.refactorize_solve(vals_ac, rhs_ac, rhs_pattern=rhs_pattern)
    n_batched += 1
    if ladder is not None:
        ladder.note_refactorize()
        # AC-phase recovery: rebuild on the worst frequency point's values
        # (one shared plan, one representative for the scaling)
        reason = ladder.diagnose(glu, x)
        rebuilt_ac = False
        while reason is not None:
            if ladder.can_escalate():
                ladder.escalate(step="ac", reason=reason)
            elif not rebuilt_ac:
                ladder.retry_at_current_rung(step="ac", reason=reason)
            else:
                break
            rebuilt_ac = True
            worst = _worst_index(glu)
            try:
                glu = GLU(CSC(pat.n, pat.indptr, pat.indices, vals_ac[worst]),
                          **ladder.glu_kwargs(ac_kwargs))
            except ValueError:
                break
            n_plan_hits += int(glu.plan_from_cache)
            x = glu.refactorize_solve(vals_ac, rhs_ac,
                                      rhs_pattern=rhs_pattern)
            n_batched += 1
            reason = ladder.diagnose(glu, x)
    solve_s = time.perf_counter() - t0

    # componentwise backward error on the original systems, all F points in
    # two vectorized scatter-add SpMV passes (pattern indices built once)
    F = len(freqs)
    rows = np.broadcast_to(pat.indices, (F, len(pat.indices)))
    cols = np.repeat(np.arange(pat.n), np.diff(pat.indptr))
    batch = np.arange(F)[:, None]

    def spmv_all(vmat, xmat):
        y = np.zeros((F, n), dtype=np.result_type(vmat.dtype, xmat.dtype))
        np.add.at(y, (batch, rows), vmat * xmat[:, cols])
        return y

    r = spmv_all(vals_ac, x) - rhs_ac
    denom = spmv_all(np.abs(vals_ac), np.abs(x)) + np.abs(rhs_ac)
    max_berr = float(np.where(denom > 0,
                              np.abs(r) / np.where(denom > 0, denom, 1.0),
                              np.where(np.abs(r) > 0, np.inf, 0.0)).max())

    return ACSweepResult(
        freqs=freqs,
        voltages=x,
        op_point=v,
        op_newton_iters=op_iters,
        n_batched_factorizations=n_batched,
        setup_seconds=setup_s,
        solve_seconds=solve_s,
        max_backward_error=max_berr,
        plan_cache_hits=n_plan_hits,
        op_converged=op_converged,
        n_full_rebuilds=0 if ladder is None else ladder.n_full_rebuilds,
        ladder_counts=(_empty_ladder_counts() if ladder is None
                       else dict(ladder.counts)),
        n_devices=glu.n_devices if len(freqs) > 1 else 1,
    )
