"""Adaptive refactorization ladder: per-step recovery-escalation policy.

GLU3.0's premise is that the numeric phase repeats many times on one
symbolic plan, so the right response to a degraded factorization is the
CHEAPEST one that restores health — not an unconditional full rebuild.
Following CKTSO's per-step adaptivity (arXiv 2411.14082), the drivers in
:mod:`.simulate` climb a four-rung ladder:

  rung 0  ``refactorize``  numeric refactorization on the existing plan and
                           scaling — the normal per-iterate action (free).
  rung 1  ``rescale``      rebuild with a fresh MC64 matching/scaling
                           computed on the CURRENT values (the operating
                           point drifted away from what setup-time scaling
                           saw).  Symbolic plan is a cache hit.
  rung 2  ``bump``         rung 1 plus the SuperLU_DIST-style static pivot
                           guard (|diag| < eps * max|A| bumped to the
                           threshold).  Still a plan-cache hit — the guard
                           is a numeric-phase knob, not a symbolic one.
  rung 3  ``replan``       full symbolic replan from scratch (bypassing the
                           plan cache), with rungs 1+2 still applied — the
                           last resort when the cached analysis itself is
                           suspected.

The rung is STICKY and monotonic: once the ladder escalates, later rebuilds
within the same run use at least that rung (the condition that forced the
climb — an operating point the original scaling can't handle — rarely goes
away mid-run, and oscillating between configurations would thrash the
Newton loop).  Because the driver keeps using the rebuilt solver object,
stickiness costs nothing while the run stays healthy: no further rebuilds
fire unless diagnostics degrade again.

Diagnostics (:meth:`RefactorizationLadder.diagnose`) are tiered by cost:
a host-side finiteness check of the solution is free; when iterative
refinement ran, its converged flag is read without forcing any deferred
device reductions; only when refinement is off (``check_growth="auto"``)
does the ladder pull ``solve_info``'s pivot-growth / min-diag reductions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["RUNGS", "LadderConfig", "RefactorizationLadder"]

RUNGS = ("refactorize", "rescale", "bump", "replan")


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Thresholds and policy knobs for the escalation ladder.

    ``growth_max``      pivot growth (max|LU|/max|A|) above which an
                        unrefined factorization is declared unhealthy.
    ``min_diag_floor``  post-factorization diagonal magnitudes at or below
                        this are unhealthy (0.0: only exact zeros).
    ``pivot_eps``       relative static-pivot threshold the ``bump`` rung
                        applies (when the run's own static_pivot is larger,
                        the larger value wins).
    ``check_growth``    ``"auto"`` — growth/min-diag checks only when
                        iterative refinement is off (refinement's backward
                        error is the sharper and cheaper signal);
                        ``"always"`` / ``"never"`` force them on/off.
    ``max_rung``        highest rung the ladder may climb to (3 = replan).
    """
    growth_max: float = 1e8
    min_diag_floor: float = 0.0
    pivot_eps: float = 1e-10
    check_growth: str = "auto"
    max_rung: int = 3

    def __post_init__(self):
        if self.check_growth not in ("auto", "always", "never"):
            raise ValueError(f"check_growth must be auto/always/never, "
                             f"got {self.check_growth!r}")
        if not 0 <= self.max_rung < len(RUNGS):
            raise ValueError(f"max_rung must be in [0, {len(RUNGS) - 1}]")


class RefactorizationLadder:
    """Escalation state machine shared by a driver run.

    The driver calls :meth:`note_refactorize` for every plain numeric
    refactorization, :meth:`diagnose` after each solve, and — while
    diagnose keeps returning a reason — :meth:`escalate` +
    :meth:`glu_kwargs` to rebuild the solver one rung up and retry.
    ``counts`` / ``events`` / ``n_full_rebuilds`` are the reporting
    surface the result dataclasses expose.
    """

    def __init__(self, config: Optional[LadderConfig] = None):
        self.config = config or LadderConfig()
        self.rung = 0
        self.counts = {name: 0 for name in RUNGS}
        self.events: list[dict] = []

    @property
    def rung_name(self) -> str:
        return RUNGS[self.rung]

    @property
    def n_full_rebuilds(self) -> int:
        """Solver reconstructions the ladder triggered (rungs 1-3); plain
        rung-0 refactorizations are not rebuilds."""
        return sum(self.counts[name] for name in RUNGS[1:])

    def note_refactorize(self) -> None:
        self.counts["refactorize"] += 1

    def can_escalate(self) -> bool:
        return self.rung < self.config.max_rung

    def escalate(self, step=None, reason: str = "") -> str:
        """Climb one rung (sticky), record the event, return the new rung's
        name.  Raises if already at ``max_rung`` — guard with
        :meth:`can_escalate`."""
        if not self.can_escalate():
            raise RuntimeError("ladder already at max_rung")
        self.rung += 1
        name = self.rung_name
        self.counts[name] += 1
        self.events.append({"step": step, "rung": name, "reason": reason})
        return name

    def retry_at_current_rung(self, step=None, reason: str = "") -> str:
        """Record a rebuild retry at the current (already escalated) rung —
        used when a LATER step degrades again after the ladder climbed."""
        name = self.rung_name
        if self.rung > 0:
            self.counts[name] += 1
        self.events.append({"step": step, "rung": name, "reason": reason})
        return name

    def diagnose(self, glu, x=None) -> Optional[str]:
        """Health check of the latest factorize+solve; returns a reason
        string when recovery should fire, ``None`` when healthy.

        ``x`` is the host-side solution array (any shape) — a NaN/Inf there
        is the cheapest and most damning signal.  Next, a refined solve's
        converged flag (free: no deferred reductions).  Only for unrefined
        solves (under ``check_growth="auto"``) are the pivot-growth /
        min-diag device reductions forced.
        """
        if x is not None and not np.all(np.isfinite(x)):
            return "non-finite solution"
        conv = glu.refine_converged
        if conv is not None:
            if not np.asarray(conv).all():
                return "iterative refinement stalled above tolerance"
            if self.config.check_growth != "always":
                return None
        elif self.config.check_growth == "never":
            return None
        info = glu.solve_info
        if info is None:
            return None
        growth = np.asarray(info["pivot_growth"])
        min_diag = np.asarray(info["min_diag"])
        if np.any(~np.isfinite(growth)) or np.any(growth > self.config.growth_max):
            return (f"pivot growth {float(np.max(growth)):.3g} exceeds "
                    f"{self.config.growth_max:.3g}")
        if np.any(~np.isfinite(min_diag)) or np.any(
                min_diag <= self.config.min_diag_floor):
            return (f"min |diag| {float(np.min(min_diag)):.3g} at or below "
                    f"floor {self.config.min_diag_floor:.3g}")
        return None

    def glu_kwargs(self, base: dict) -> dict:
        """Constructor kwargs for a rebuild at the current rung: ``base``
        (the driver's own GLU options) with the rung's overrides applied."""
        kw = dict(base)
        if self.rung >= 1:
            kw["mc64"] = "scale"
        if self.rung >= 2:
            prev = kw.get("static_pivot")
            kw["static_pivot"] = (self.config.pivot_eps if prev is None
                                  else max(float(prev), self.config.pivot_eps))
        if self.rung >= 3:
            kw["plan_cache"] = None
        return kw
