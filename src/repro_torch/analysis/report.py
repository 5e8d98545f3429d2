"""Structured verification results.

Every check in the analysis subsystem reports through a
:class:`VerifyReport`: a flat list of :class:`Violation` records plus the
names of the checks that ran.  Reports are cheap append-only containers —
checks never raise on a finding; callers decide via
:meth:`VerifyReport.raise_if_violated` (the ``GLU(verify=...)`` knob does).

Violation codes are a closed vocabulary (see ``CODES``) so tests and CI can
assert on *which* invariant broke, not just that one did.  ``CODES`` holds
the JAX package's codes with their meaning unchanged (``REFERENCE_CODES``),
so the two packages' reports compare code for code, and a separate group of
codes for facts only this package's executor has (``PORT_CODES``).

A check that could not run where it was asked for (the CUDA-graph audit on
a machine without a card) is recorded with :meth:`VerifyReport.skip` and
its reason: it neither raises nor counts as a check that ran, and the
summary lists it apart.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Violation", "VerifyReport", "PlanVerificationError", "CODES",
           "REFERENCE_CODES", "PORT_CODES"]

# code -> one-line meaning: the JAX package's closed violation vocabulary,
# each code with the same meaning (the audit codes read "program" as the
# captured CUDA graph of a factorization or solve)
REFERENCE_CODES = {
    # pattern / plan shape
    "PATTERN_MALFORMED": "CSC pattern arrays are not a valid sorted pattern",
    "DIAG_MISMATCH": "diag_idx does not point at the diagonal entries",
    "LEVELS_MALFORMED": "levels/order/level_ptr are mutually inconsistent",
    # schedule races (static, against the recomputed dependency DAG)
    "RACE_INTRA_LEVEL": "a dependency edge connects two same-level columns",
    "RACE_LEVEL_ORDER": "a dependency edge points level-backward",
    # normalisation arrays
    "NORM_OOB": "normalisation index outside [0, nnz)",
    "NORM_MISMATCH": "norm_idx/norm_diag disagree with the pattern's L entries",
    # update triples
    "TRIPLE_OOB": "update-triple index outside [0, nnz)",
    "TRIPLE_INCONSISTENT": "lidx/uidx/didx/dst_col rows+cols disagree",
    "TRIPLE_ORDER": "triples not sorted by (level, destination column)",
    "TRIPLE_SET_MISMATCH": "update-triple multiset differs from the pattern's",
    # A-value scatter map
    "SCATTER_OOB": "a_scatter slot outside [0, nnz)",
    "SCATTER_COLLISION": "a_scatter maps two A entries to one filled slot",
    "SCATTER_MISMATCH": "a_scatter target coordinates differ from A's",
    # triangular-solve schedules
    "TRISOLVE_FWD_RACE": "forward-solve entry reads a not-yet-final x",
    "TRISOLVE_FWD_SET": "forward-solve entry set differs from L's",
    "TRISOLVE_BWD_RACE": "backward-solve entry reads a not-yet-final x",
    "TRISOLVE_BWD_SET": "backward-solve entry/column set differs from U's",
    # reach closures
    "REACH_ADJ_MISMATCH": "plan DAG adjacency differs from the pattern's",
    "REACH_UNDER": "reach closure under-approximates (drops trisolve work)",
    "REACH_OVER": "reach closure over-approximates the true closure",
    # executed-schedule walk (post-bucketing groups)
    "EXEC_PAD_OOB": "group index outside [0, nnz] (nnz is the drop slot)",
    "EXEC_RACE": "an executed step writes an entry at/after a consuming read",
    "EXEC_SOURCE_ORDER": "an update fires before its source column is normal",
    "EXEC_NORM_COVERAGE": "executed normalisations differ from the plan's",
    "EXEC_UPDATE_COVERAGE": "executed update triples differ from the plan's",
    "EXEC_DENSE_TAIL": "dense-tail position map disagrees with the pattern",
    # jaxpr audit of the fused runners
    "AUDIT_CALLBACK": "fused program contains a host callback primitive",
    "AUDIT_DONATION": "buffer-donation contract of the runner not honoured",
    "AUDIT_DISPATCH": "whole-schedule execution is not a single dispatch",
}

# facts of this package's executor that the JAX package's has not: a flat
# level or a sweep level adds in fixed-order rounds of distinct targets
# (``kernels.ops.round_order``), and a K1 run synchronises its levels with
# one grid barrier each, safe only under the run invariants I1-I3
# (``kernels.level_update.check_run_invariants``)
PORT_CODES = {
    "EXEC_ROUND_TARGETS":
        "a round of a flat or sweep level writes one target twice, or its "
        "round bounds do not tile the level's entries",
    "EXEC_RUN_INVARIANT": "a K1 run's layout breaks the run invariants I1-I3",
}

CODES = {**REFERENCE_CODES, **PORT_CODES}


@dataclasses.dataclass
class Violation:
    """One broken invariant.  ``context`` carries small structured details
    (offending indices, counts) for tests and CLI output."""

    code: str
    message: str
    context: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown violation code {self.code!r}")

    def __str__(self) -> str:
        ctx = ""
        if self.context:
            parts = ", ".join(f"{k}={v}" for k, v in self.context.items())
            ctx = f" [{parts}]"
        return f"{self.code}: {self.message}{ctx}"


class PlanVerificationError(RuntimeError):
    """Raised by ``raise_if_violated`` / ``GLU(verify=...)`` on findings."""

    def __init__(self, report: "VerifyReport"):
        self.report = report
        lines = [str(v) for v in report.violations[:10]]
        extra = len(report.violations) - len(lines)
        if extra > 0:
            lines.append(f"... and {extra} more")
        super().__init__(
            "plan verification failed with "
            f"{len(report.violations)} violation(s):\n  " + "\n  ".join(lines))


@dataclasses.dataclass
class VerifyReport:
    """Outcome of one verification run: which checks ran, what they found."""

    checks: list = dataclasses.field(default_factory=list)
    violations: list = dataclasses.field(default_factory=list)
    # check -> reason, for checks that were asked for and could not run
    skipped: dict = dataclasses.field(default_factory=dict)

    # per-code cap on recorded examples; further findings only bump the
    # count in the first record's context (keeps reports bounded on
    # badly corrupted plans)
    MAX_PER_CODE = 8

    def ran(self, check: str) -> None:
        if check not in self.checks:
            self.checks.append(check)

    def skip(self, check: str, reason: str) -> None:
        """Record that ``check`` did not run, and why."""
        self.skipped[check] = reason

    def add(self, code: str, message: str, **context) -> None:
        n = sum(1 for v in self.violations if v.code == code)
        if n >= self.MAX_PER_CODE:
            for v in self.violations:
                if v.code == code:
                    v.context["suppressed"] = v.context.get("suppressed", 0) + 1
                    break
            return
        self.violations.append(Violation(code, message, context))

    def merge(self, other: "VerifyReport") -> "VerifyReport":
        for c in other.checks:
            self.ran(c)
        self.violations.extend(other.violations)
        self.skipped.update(other.skipped)
        return self

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def codes(self) -> frozenset:
        return frozenset(v.code for v in self.violations)

    def raise_if_violated(self) -> "VerifyReport":
        if self.violations:
            raise PlanVerificationError(self)
        return self

    def summary(self) -> dict:
        """Small JSON-able digest — what ``solve_info['verify_report']``
        carries: the JAX package's keys, and the checks that did not run
        with their reasons (``skipped``)."""
        return {
            "ok": self.ok,
            "n_checks": len(self.checks),
            "n_violations": len(self.violations),
            "codes": sorted(self.codes),
            "skipped": dict(self.skipped),
        }

    def __str__(self) -> str:
        head = (f"VerifyReport: {len(self.checks)} checks, "
                f"{len(self.violations)} violation(s)")
        if self.skipped:
            head += ", not run: " + ", ".join(
                f"{c} ({r})" for c, r in self.skipped.items())
        if self.ok:
            return head + " — OK"
        return head + "\n" + "\n".join(f"  {v}" for v in self.violations)
