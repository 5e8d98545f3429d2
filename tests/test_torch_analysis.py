"""PyTorch port, the plan sanitizer (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``) on the CPU.

* ``verify_plan`` runs the reference's checks and reports its codes on
  golden plans (both symbolic engines), and on each of the seven
  ``MUTATIONS`` over several seeds, where ``mutate_plan`` must give the
  reference's corrupted arrays from the same rng;
* ``verify_executor`` / ``verify_trisolver`` walk the port's real
  schedules (``default``, ``nodense``, ``noflat``, ``allflat``) clean, as
  the reference's walk of its own schedule on the same plan is, and flag a
  merged pair of dependent steps (``EXEC_RACE``), a swapped sweep level
  and a round with a repeated target (the port's own
  ``EXEC_ROUND_TARGETS``);
* ``GLU(verify=...)`` records its report, and the CUDA-graph audit reads
  as not run on the CPU, never as passed.

The reference's ``audit_*`` and ``verify_glu(..., "full")`` fail under
jax 0.9 (``jax.core.ClosedJaxpr`` is gone), so they are no oracle here.
Inputs: ``make_suite_matrix("rajat12_like", 0.2, seed=3)`` (the
reference's own golden matrix), ``circuit_jacobian(200, avg_degree=6.0)``
(a flat level, a K1 run and a dense tail) and grid64 at scale 0.25.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

import repro.analysis as janalysis
import repro.core as jcore
import repro.sparse as jsparse
import repro_torch
import repro_torch.sparse as tsparse
from repro.core.factorize import JaxFactorizer
from repro_torch.analysis import (
    CODES,
    MUTATIONS,
    PORT_CODES,
    REFERENCE_CODES,
    PlanVerificationError,
    VerifyReport,
    audit_factorize,
    audit_trisolve,
    merge_executor_steps,
    mutate_plan,
    verify_executor,
    verify_glu,
    verify_plan,
    verify_trisolver,
)
from repro_torch.analysis import cli
from repro_torch.analysis.schedule import host_groups
from repro_torch.core import TorchFactorizer, TorchTriangularSolver

GOLDEN = dict(name="rajat12_like", scale=0.2, seed=3)
# executor variants: (TorchFactorizer options, JaxFactorizer options)
VARIANTS = {
    "default": {},
    "nodense": dict(dense_tail=False),
    "noflat": dict(disable_modes=("flat",)),
    "allflat": dict(mode_override="flat"),
}
SCHEDULE_MATRICES = {
    "circuit200": lambda pkg: pkg.circuit_jacobian(200, avg_degree=6.0, seed=0),
    "grid64": lambda pkg: pkg.make_suite_matrix("grid64", 0.25),
}


@pytest.fixture(scope="module")
def golden():
    """The golden matrix's GLU in both packages, per symbolic engine."""
    out = {}
    for eng in ("gp", "vectorized"):
        gj = jcore.GLU(jsparse.make_suite_matrix(**GOLDEN), symbolic=eng,
                       plan_cache=None)
        gt = repro_torch.GLU(tsparse.make_suite_matrix(**GOLDEN), symbolic=eng,
                             device="cpu", plan_cache=None)
        out[eng] = (gj, gt)
    return out


@pytest.fixture(scope="module")
def schedules():
    """Per matrix: the reference GLU, the port's plan carried over from
    it, and the port's solver."""
    out = {}
    for name, make in SCHEDULE_MATRICES.items():
        gj = jcore.GLU(make(jsparse), dtype=jnp.float64, use_pallas=True,
                       plan_cache=None)
        sp = repro_torch.symbolic_plan_from_arrays(
            repro_torch.plan_to_arrays(gj.symbolic_plan))
        out[name] = dict(gj=gj, sp=sp, solver=TorchTriangularSolver(
            sp.fplan, device="cpu"))
    return out


def _arrays(plan):
    return repro_torch.plan_to_arrays(plan)


# -- verify_plan against the reference ------------------------------------------

@pytest.mark.parametrize("engine", ["gp", "vectorized"])
def test_golden_plan_checks_equal_reference(golden, engine):
    gj, gt = golden[engine]
    want = janalysis.verify_plan(gj.symbolic_plan)
    got = verify_plan(gt.symbolic_plan)
    assert got.ok and want.ok, str(got)
    assert got.checks == want.checks
    assert got.codes == want.codes
    assert gt.symbolic_plan.verify().ok and gt.plan.verify().ok
    # the two packages' plans are the same arrays: each verifier accepts
    # the other's plan too
    assert verify_plan(gj.symbolic_plan).ok
    assert janalysis.verify_plan(gt.symbolic_plan).ok


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", MUTATIONS)
def test_mutation_matches_reference_and_is_flagged(golden, kind, seed):
    gj, gt = golden["gp"]
    pj, want_codes, info_j = janalysis.mutate_plan(
        gj.plan, kind, np.random.default_rng(seed))
    pt, codes, info_t = mutate_plan(gt.plan, kind, np.random.default_rng(seed))
    assert codes == want_codes and info_t == info_j
    aj, at = _arrays(pj), _arrays(pt)
    assert aj.keys() == at.keys()
    for k in aj:
        assert np.array_equal(np.asarray(at[k]), np.asarray(aj[k])), k
    seeds = info_t.get("seed_sets")
    rep = verify_plan(pt, reach_seed_sets=seeds)
    assert codes <= rep.codes, (kind, sorted(rep.codes))
    assert rep.codes == janalysis.verify_plan(
        pj, reach_seed_sets=info_j.get("seed_sets")).codes
    # the golden plan is untouched
    assert verify_plan(gt.plan).ok


@pytest.mark.parametrize("chunk", [None, 997], ids=["default-chunk", "small-chunk"])
@pytest.mark.parametrize("kind", ["swap_levels", "fuse_dependent_pair",
                                  "corrupt_triple"])
def test_triple_check_reports_as_reference(golden, monkeypatch, kind, chunk):
    """The port checks update triples in chunks; its findings (codes,
    messages, counts and the first bad triple) are the reference's, with
    chunk boundaries inside the plan's triples too."""
    from repro_torch.analysis import invariants

    if chunk is not None:
        monkeypatch.setattr(invariants, "_CHUNK", chunk)
    gj, gt = golden["gp"]
    assert len(gt.plan.lidx) > 20 * 997
    pj, _, _ = janalysis.mutate_plan(gj.plan, kind, np.random.default_rng(7))
    pt, _, _ = mutate_plan(gt.plan, kind, np.random.default_rng(7))

    def findings(rep):
        return [(v.code, v.message, v.context) for v in rep.violations
                if v.code.startswith("TRIPLE")]

    want = findings(janalysis.verify_plan(pj))
    assert want or kind != "corrupt_triple"
    assert findings(verify_plan(pt)) == want


# -- executed schedules ---------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("matrix", list(SCHEDULE_MATRICES))
def test_real_schedules_verify_clean(schedules, matrix, variant):
    s = schedules[matrix]
    opts = VARIANTS[variant]
    fact = TorchFactorizer(s["sp"].fplan, device="cpu", **opts)
    rep = verify_executor(fact)
    assert rep.ok, str(rep)
    want = janalysis.verify_executor(JaxFactorizer(
        s["gj"].plan, dtype=jnp.float64, use_pallas=True, **opts))
    assert want.ok
    assert rep.checks == want.checks
    if variant == "noflat":
        assert fact.step_kinds.count("flat") <= 1


@pytest.mark.parametrize("matrix", list(SCHEDULE_MATRICES))
def test_trisolver_schedules_verify_clean(schedules, matrix):
    s = schedules[matrix]
    solver = s["solver"]
    assert verify_trisolver(solver).ok
    assert janalysis.verify_trisolver(s["gj"]._solver).ok
    n = solver.plan.n
    for pattern in ([0], [n // 2], [0, n // 3, n - 1]):
        rep = verify_trisolver(solver, rhs_pattern=pattern)
        assert rep.ok, str(rep)
        assert rep.checks == ["trisolve_schedule_pruned"]


@pytest.mark.parametrize("variant", ["default", "allflat"])
@pytest.mark.parametrize("matrix", list(SCHEDULE_MATRICES))
def test_merged_steps_flagged(schedules, matrix, variant):
    """A K1 run with two dependent levels joined (default) or two
    dependent flat steps joined (allflat) races; the joined run also
    breaks I1-I3.  The reference's merge of its own schedule is flagged
    with the same code."""
    s = schedules[matrix]
    fact = TorchFactorizer(s["sp"].fplan, device="cpu", **VARIANTS[variant])
    merged = merge_executor_steps(fact)
    assert merged is not None
    groups, codes = merged
    kinds = [k for k, _ in groups]
    assert len(kinds) == len(fact.step_kinds) - (variant == "allflat")
    rep = verify_executor(fact, groups=groups)
    assert codes == {"EXEC_RACE"} and codes <= rep.codes, str(rep)
    if variant == "default":
        assert "EXEC_RUN_INVARIANT" in rep.codes
    fj = JaxFactorizer(s["gj"].plan, dtype=jnp.float64, fuse_buckets=False)
    ref = janalysis.merge_executor_steps(fj)
    if ref is not None:
        rk, ra, rc = ref
        assert rc <= janalysis.verify_executor(fj, kinds=rk,
                                               group_arrays=ra).codes
    # the factorizer's own schedule is untouched
    assert verify_executor(fact).ok


@pytest.mark.parametrize("sweep", ["fwd", "bwd"])
def test_swapped_sweep_level_flagged(schedules, sweep):
    solver = schedules["circuit200"]["solver"]
    fwd, bwd = list(solver.fwd_levels), list(solver.bwd_levels)
    levels = fwd if sweep == "fwd" else bwd
    levels[0], levels[1] = levels[1], levels[0]
    rep = verify_trisolver(solver, fwd_levels=fwd, bwd_levels=bwd)
    code = "TRISOLVE_FWD_RACE" if sweep == "fwd" else "TRISOLVE_BWD_RACE"
    assert code in rep.codes, str(rep)


def test_round_with_repeated_target_flagged(schedules):
    """The port's own codes: a flat level whose rounds are collapsed into
    one (a target repeats inside it), and a sweep level likewise."""
    s = schedules["circuit200"]
    fact = TorchFactorizer(s["sp"].fplan, device="cpu", mode_override="flat")
    groups = host_groups(fact)
    gi = next(i for i, (k, a) in enumerate(groups)
              if k == "flat" and len(a["bounds"]) > 2)
    arrs = dict(groups[gi][1])
    arrs["bounds"] = np.array([0, len(arrs["didx"])])
    groups[gi] = ("flat", arrs)
    rep = verify_executor(fact, groups=groups)
    assert rep.codes == {"EXEC_ROUND_TARGETS"}, str(rep)

    solver = s["solver"]
    fwd = list(solver.fwd_levels)
    t = next(i for i, lev in enumerate(fwd) if len(lev[-1]) > 2)
    fwd[t] = tuple(fwd[t][:-1]) + ([0, len(fwd[t][0])],)
    rep = verify_trisolver(solver, fwd_levels=fwd)
    assert rep.codes == {"EXEC_ROUND_TARGETS"}, str(rep)


def test_port_codes_are_a_separate_group():
    assert set(REFERENCE_CODES) == set(janalysis.CODES)
    for code, meaning in janalysis.CODES.items():
        assert REFERENCE_CODES[code] == meaning
    assert not set(PORT_CODES) & set(REFERENCE_CODES)
    assert CODES == {**REFERENCE_CODES, **PORT_CODES}


# -- the GLU(verify=...) knob and the graph audit on the CPU ----------------------

@pytest.mark.parametrize("level", ["plan", "full"])
def test_glu_verify_records_report(level):
    A = tsparse.circuit_jacobian(200, avg_degree=6.0, seed=0)
    g = repro_torch.GLU(A, device="cpu", verify=level)
    assert g.verify == level and g.verify_report.ok
    g.factorize()
    info = g.solve_info["verify_report"]
    assert info["ok"] is True and info["n_violations"] == 0
    assert set(janalysis.VerifyReport().summary()) <= set(info)
    if level == "plan":
        assert info["skipped"] == {}
        assert "exec_schedule" not in g.verify_report.checks
    else:
        # the executed schedules were walked; the graph audit could not run
        assert {"exec_schedule", "trisolve_schedule"} <= set(
            g.verify_report.checks)
        assert info["skipped"] == {"audit_factorize": "no CUDA device",
                                   "audit_trisolve": "no CUDA device"}
    g.factorize_batched(np.asarray(A.data)[None].repeat(2, axis=0))
    assert g.solve_info["verify_report"] == info


def test_glu_verify_off_is_default():
    g = repro_torch.GLU(tsparse.circuit_jacobian(60, seed=1), device="cpu")
    assert g.verify == "off" and g.verify_report is None
    g.factorize()
    assert g.solve_info["verify_report"] is None


def test_glu_verify_raises_on_a_corrupt_plan():
    A = tsparse.circuit_jacobian(200, avg_degree=6.0, seed=0)
    sp, _, _ = repro_torch.core.plan_factorization(A, cache=None)
    bad, codes, _ = mutate_plan(sp.fplan, "truncate_reach",
                                np.random.default_rng(0))
    sp_bad = dataclasses.replace(sp, fplan=bad)
    with pytest.raises(PlanVerificationError, match="REACH_ADJ_MISMATCH"):
        repro_torch.GLU.from_plan(sp_bad, A, device="cpu", verify="plan")
    repro_torch.GLU.from_plan(sp_bad, A, device="cpu")   # "off" checks nothing


def test_cpu_graph_audit_reads_as_not_run(schedules):
    s = schedules["circuit200"]
    fact = TorchFactorizer(s["sp"].fplan, device="cpu")
    for rep in (audit_factorize(fact), audit_trisolve(s["solver"])):
        assert rep.checks == [] and rep.violations == []
        assert list(rep.skipped.values()) == ["no CUDA device"]
        assert rep.summary()["n_checks"] == 0
        assert "not run" in str(rep)
    # the same on a schedule that issues its steps one by one: no card,
    # no audit (it is not a pass either way)
    eager = TorchFactorizer(s["sp"].fplan, device="cpu", jit_schedule=False)
    assert audit_factorize(eager).skipped


def test_report_merges_skips():
    rep = VerifyReport()
    rep.ran("races")
    other = VerifyReport()
    other.skip("audit_factorize", "no CUDA device")
    rep.merge(other)
    assert rep.ok and rep.checks == ["races"]
    assert rep.summary()["skipped"] == {"audit_factorize": "no CUDA device"}
    with pytest.raises(ValueError, match="unknown violation code"):
        rep.add("NOT_A_CODE", "nope")


def test_verify_glu_rejects_unknown_level():
    g = repro_torch.GLU(tsparse.circuit_jacobian(60, seed=1), device="cpu")
    with pytest.raises(ValueError, match="level"):
        verify_glu(g, "maybe")


# -- the command line -------------------------------------------------------------

def test_cli_small_zoo_verifies(capsys):
    rc = cli.main(["--matrices", "grid64,rajat12_like", "--scale", "0.1",
                   "--engines", "gp", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("OK ") == 2 * len(cli.VARIANTS)
    assert "not run" in out and "all cases verified" in out


def test_cli_exits_1_on_a_violation(monkeypatch, capsys):
    def corrupt(A, engine, variant, device):
        glu = build(A, engine, variant, device)
        glu.symbolic_plan = dataclasses.replace(
            glu.symbolic_plan, fplan=mutate_plan(
                glu.plan, "drop_norm", np.random.default_rng(0))[0])
        return glu

    build = cli.build_case
    monkeypatch.setattr(cli, "build_case", corrupt)
    rc = cli.main(["--matrices", "grid64", "--scale", "0.1", "--engines", "gp",
                   "--variants", "default", "--level", "plan",
                   "--device", "cpu"])
    assert rc == 1
    assert "NORM_OOB" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--variants", "nofuse", "--device", "cpu"])
