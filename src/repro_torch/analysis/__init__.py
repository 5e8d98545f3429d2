"""Static analysis of symbolic plans and built executor schedules (the JAX
package's ``analysis/`` on this package's plans and steps).

The subsystem proves — from first principles, against the filled matrix
pattern — that a :class:`~repro_torch.core.plan.FactorizePlan` and the
schedules built from it are safe to run:

* :func:`verify_plan` — recomputes the column dependency DAG from the
  pattern (the *exact* hazard set of the level-synchronous executor, via
  :func:`~repro_torch.core.dependency.dependencies_exact`) and checks the
  levelization against it, plus every index array the plan carries
  (normalisation entries, update triples, A-scatter map, triangular-solve
  schedules, reach closures).
* :func:`verify_executor` / :func:`verify_trisolver` — walk the *built*
  steps (flat levels in rounds, K1 runs, the dense tail; the sweeps, full
  or pruned to a right-hand-side pattern) with an exact write/read timing
  model, so they are verified as executed, not as planned.
* :func:`audit_factorize` / :func:`audit_trisolve` — replay the captured
  CUDA graphs of a scratch executor: one dispatch, no host
  synchronization, no write to a buffer the replay does not own.  Without
  a card they record that they did not run.
* :func:`verify_glu` — all of the above over a built
  :class:`~repro_torch.core.api.GLU`; this is what the ``GLU(verify=...)``
  knob runs.

Findings come back as a :class:`VerifyReport` of coded :class:`Violation`
records (closed vocabulary in :data:`CODES`: the JAX package's codes, and
the port's own in :data:`PORT_CODES`); :mod:`.mutate` provides the
corruptors the tests use to prove the detector has no false negatives.

Run ``python -m repro_torch.analysis.cli`` to sweep the matrix zoo.
"""
from __future__ import annotations

from .graph_audit import audit_factorize, audit_trisolve
from .invariants import verify_plan
from .mutate import MUTATIONS, merge_executor_steps, mutate_plan
from .report import (
    CODES,
    PORT_CODES,
    REFERENCE_CODES,
    PlanVerificationError,
    VerifyReport,
    Violation,
)
from .schedule import verify_executor, verify_trisolver

__all__ = [
    "CODES",
    "MUTATIONS",
    "PORT_CODES",
    "REFERENCE_CODES",
    "PlanVerificationError",
    "VerifyReport",
    "Violation",
    "audit_factorize",
    "audit_trisolve",
    "merge_executor_steps",
    "mutate_plan",
    "verify_executor",
    "verify_glu",
    "verify_plan",
    "verify_trisolver",
]


def verify_glu(glu, level: str = "full", *, reach_trials: int = 8,
               seed: int = 0) -> VerifyReport:
    """Verify a built :class:`~repro_torch.core.api.GLU` instance.

    ``level="plan"`` checks the symbolic plan only; ``"full"`` additionally
    walks the built factorizer and trisolver schedules and audits their
    CUDA-graph replays (recorded as not run on the CPU).  Returns the
    merged :class:`VerifyReport`; raising on violations is the caller's
    choice (``GLU(verify=...)`` raises).
    """
    if level not in ("plan", "full"):
        raise ValueError(f"level must be 'plan' or 'full', got {level!r}")
    rep = verify_plan(glu.symbolic_plan, reach_trials=reach_trials, seed=seed)
    if level == "full":
        rep.merge(verify_executor(glu._factorizer))
        rep.merge(verify_trisolver(glu._solver))
        rep.merge(audit_factorize(glu._factorizer))
        rep.merge(audit_trisolve(glu._solver, glu.dtype))
    return rep
