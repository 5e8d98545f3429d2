"""Audit of the captured CUDA graphs: the counterpart of the JAX package's
jaxpr audit (``analysis/jaxpr_audit.py``) for :class:`~repro_torch.core.
executor.CapturedSchedule`.

On the card a factorization and an unrefined solve are each one replay of
a graph captured over static buffers.  The audit replays a graph of the
executor's own schedule and checks the properties the performance story
rests on, under the JAX package's codes:

* **one dispatch** (``AUDIT_DISPATCH``): ``jit_schedule=True``, and a
  factorization or a solve is one replay;
* **no host synchronization** (``AUDIT_CALLBACK``): the replay runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so any operation in it that
  waits for the device raises (a capture that fails already raises, so
  the replays are what is left to check);
* **buffer contract** (``AUDIT_DONATION``): a factorization replay writes
  only its own buffers (its A values, its filled values, its bump count):
  the shared schedule's index tensors and the buffers of every other
  factorizer on the plan keep their bits; a solve replay leaves the factor
  values and the caller's right-hand side bit for bit unchanged (the JAX
  package's "trisolve donates nothing").

The audit never touches the caller's buffers: it replays a scratch
factorizer and solver that share the plan's built schedules through the
executable cache (so it audits the very index tensors the caller's graphs
read), on values of the same dtype with ones on the diagonal, so nothing
divides by zero.  A CPU executor has no graph: the audit records that it
did not run, with the reason "no CUDA device" (``VerifyReport.skip``),
which neither raises nor counts as a check that passed.

What this does not guarantee: numeric correctness (``verify_plan`` and
``verify_executor`` prove the schedule) or the graphs' speed.
"""
from __future__ import annotations

import torch

from ..core.triangular import TorchTriangularSolver
from .report import VerifyReport

__all__ = ["audit_factorize", "audit_trisolve"]

NO_DEVICE = "no CUDA device"


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A copy of the tensor's bytes (so that a NaN compares equal to
    itself), through a fresh dense buffer: a one-element index tensor may
    carry a stride of 0, which no byte view accepts."""
    flat = torch.empty(t.numel(), dtype=t.dtype, device=t.device)
    return flat.copy_(t.detach().reshape(-1)).view(torch.uint8)


def _snapshot(named) -> list:
    return [(name, t, _bits(t)) for name, t in named]


def _changed(snap) -> list:
    return [name for name, t, b in snap if not torch.equal(_bits(t), b)]


def _schedule_tensors(fact) -> list:
    """Every device index tensor of the factorizer's shared built steps."""
    sched = fact._sched
    out = [("a_scatter", sched.a_scatter), ("diag_idx", sched.diag_idx)]
    for gi, g in enumerate(sched.groups):
        if g.kind == "run":
            out += [(f"run {gi} {k}", t) for k, t in g.arrays[0].tensors.items()]
        else:
            out += [(f"{g.kind} {gi} [{i}]", t) for i, t in enumerate(g.arrays)
                    if isinstance(t, torch.Tensor)]
        if g.diag is not None:
            out.append((f"{g.kind} {gi} diag", g.diag))
    return out


def _caller_buffers(fact) -> list:
    """The audited factorizer's own buffers, single and batched."""
    out = [("caller's a_values", fact.a_values), ("caller's values", fact._buf)]
    if fact._count is not None:
        out.append(("caller's bump count", fact._count))
    if fact._batch is not None:
        out += [(f"caller's batch {k}", fact._batch[k])
                for k in ("a_values", "buf", "count")
                if fact._batch[k] is not None]
    return out


def _unit_diagonal(plan, slots, dtype, device) -> torch.Tensor:
    """Values of ``dtype`` on the device: one where a filled slot of
    ``slots`` is a diagonal, zero elsewhere."""
    diag = torch.zeros(plan.nnz, dtype=torch.bool)
    diag[torch.as_tensor(plan.diag_idx, dtype=torch.int64)] = True
    return diag[torch.as_tensor(slots, dtype=torch.int64)].to(
        dtype=dtype, device=device)


def _replay_checked(rep, name: str, call, device) -> None:
    """One replay of ``call`` (which returns its dispatch count) under the
    sync debug mode "error": a host synchronization inside raises, and is
    recorded as ``AUDIT_CALLBACK``; more than one dispatch as
    ``AUDIT_DISPATCH``."""
    torch.cuda.synchronize(device)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        n = call()
    except RuntimeError as e:
        rep.add("AUDIT_CALLBACK",
                f"{name} replay synchronises with the host: {e}",
                runner=name)
        n = 1
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize(device)
    if n != 1:
        rep.add("AUDIT_DISPATCH",
                f"{name} replay issued {n} dispatches, not one",
                runner=name)


def audit_factorize(fact) -> VerifyReport:
    """Audit a :class:`~repro_torch.core.factorize.TorchFactorizer`'s
    captured factorization (single matrix) on a scratch twin."""
    rep = VerifyReport()
    if fact.device.type != "cuda":
        rep.skip("audit_factorize", NO_DEVICE)
        return rep
    rep.ran("audit_factorize")
    if not fact.jit_schedule:
        rep.add("AUDIT_DISPATCH",
                "jit_schedule=False: factorization issues one dispatch per "
                f"group ({fact.n_groups} groups), not one total")
        return rep
    scratch = fact.twin()
    scratch.load(_unit_diagonal(fact.plan, fact.plan.a_scatter, fact.dtype,
                                fact.device))
    scratch.run()                       # warm-up and capture
    scratch.run()                       # a first replay
    guarded = _snapshot(_schedule_tensors(scratch)
                        + _caller_buffers(fact))
    _replay_checked(rep, "factorize", lambda: (scratch.run(),
                                               scratch.last_n_dispatches)[1],
                    fact.device)
    changed = _changed(guarded)
    if changed:
        rep.add("AUDIT_DONATION",
                f"factorize replay wrote buffers it does not own: {changed}",
                runner="factorize")
    return rep


def audit_trisolve(solver, dtype=torch.float64) -> VerifyReport:
    """Audit a :class:`~repro_torch.core.triangular.TorchTriangularSolver`'s
    captured full-schedule solve on a scratch solver: one replay, no host
    synchronization, and the factor values and the right-hand side left
    as they were."""
    rep = VerifyReport()
    if solver.device.type != "cuda":
        rep.skip("audit_trisolve", NO_DEVICE)
        return rep
    rep.ran("audit_trisolve")
    if not solver.jit_schedule:
        rep.add("AUDIT_DISPATCH",
                "jit_schedule=False: a solve issues one dispatch per level "
                f"({len(solver.fwd_levels) + len(solver.bwd_levels)} "
                "levels), not one total")
        return rep
    plan = solver.plan
    scratch = TorchTriangularSolver(plan, device=solver.device,
                                    jit_schedule=True,
                                    executable_cache=solver._cache)
    vals = _unit_diagonal(plan, torch.arange(plan.nnz), dtype, solver.device)
    b = torch.linspace(1.0, 2.0, plan.n, dtype=torch.float64).to(
        dtype=dtype, device=solver.device)
    scratch.solve(vals, b)              # warm-up and capture
    scratch.solve(vals, b)              # a first replay
    guarded = _snapshot([("factor values", vals), ("right-hand side", b)]
                        + [(f"sweep level {i}", t)
                           for i, lev in enumerate(scratch.fwd_levels
                                                   + scratch.bwd_levels)
                           for t in lev[:-1]])
    _replay_checked(rep, "trisolve",
                    lambda: (scratch.solve(vals, b),
                             scratch.last_n_dispatches)[1], solver.device)
    changed = _changed(guarded)
    if changed:
        rep.add("AUDIT_DONATION",
                f"trisolve replay wrote buffers it must leave unchanged: "
                f"{changed[:4]}", runner="trisolve")
    return rep
