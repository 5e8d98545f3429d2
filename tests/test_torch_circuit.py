"""PyTorch port, circuit driver: MNA assembly, the escalation ladder and the
Newton transient of ``repro_torch.circuit`` against ``repro.circuit`` on
the CPU.  Assembly agrees byte for byte; transient voltages to 1e-9 (the
same plans, factors to rounding), with equal Newton iteration counts,
factorization counts and ladder counts, also on the cond >= 1e10 ladder
fixture of ``tests/test_ladder.py``.
"""
import numpy as np
import pytest
import torch

import repro.circuit as jcirc
import repro_torch.circuit as tcirc
from repro.circuit.simulate import transient as jax_transient
from repro.sparse import ill_conditioned_jacobian as jax_ill
from repro_torch.sparse import ill_conditioned_jacobian as torch_ill

TOL = 1e-9


def _divider(pkg):
    ckt = pkg.Circuit(3)
    ckt.add_resistor(1, 2, 1.0)
    ckt.add_resistor(2, 0, 1.0)
    ckt.add_current_source(0, 1, 1.0)
    return ckt


def _rc(pkg):
    ckt = pkg.Circuit(2)
    ckt.add_resistor(1, 0, 2.0)
    ckt.add_capacitor(1, 0, 1.0)
    ckt.add_current_source(0, 1, 1.0)
    return ckt


def _diode(pkg):
    ckt = pkg.Circuit(2)
    ckt.add_resistor(1, 0, 100.0)
    ckt.add_diode(1, 0)
    ckt.add_current_source(0, 1, 0.1)
    return ckt


# (circuit builder, transient keyword arguments): the test_circuit.py
# divider, RC and diode cases, and two grids with diodes
CASES = {
    "divider": (_divider, dict(t_end=0.01, dt=0.01)),
    "rc": (_rc, dict(t_end=20.0, dt=0.5)),
    "diode": (_diode, dict(t_end=0.01, dt=0.01, max_newton=60)),
    "grid4x4": (lambda pkg: pkg.rc_grid_circuit(4, 4, with_diodes=True,
                                                seed=1),
                dict(t_end=0.02, dt=0.005)),
    "grid5x5": (lambda pkg: pkg.rc_grid_circuit(5, 5, with_diodes=True,
                                                seed=2),
                dict(t_end=0.03, dt=0.005)),
    "grid4x4-refined-pivot": (lambda pkg: pkg.rc_grid_circuit(
        4, 4, with_diodes=True, seed=2),
        dict(t_end=0.01, dt=0.005, refine=2, static_pivot=1e-10)),
}


@pytest.fixture(scope="module")
def reference():
    """The reference's transient result for each case, built once."""
    return {}


def _reference(reference, name):
    if name not in reference:
        build, kw = CASES[name]
        reference[name] = jax_transient(build(jcirc), **kw)
    return reference[name]


@pytest.mark.parametrize("name", ["grid4x4", "grid5x5"])
def test_assembly_matches_reference_bytes(name):
    """Pattern, values and right-hand side at several (v, t), byte for
    byte, and the AC systems too."""
    build, _ = CASES[name]
    cj, ct = build(jcirc), build(tcirc)
    pj, pt = cj.pattern(), ct.pattern()
    for a in ("indptr", "indices", "data"):
        assert getattr(pj, a).tobytes() == getattr(pt, a).tobytes(), a
    rng = np.random.default_rng(3)
    for t in (0.0, 0.13, 0.4):
        v = rng.uniform(-1.0, 1.0, size=cj.n)
        v_prev = rng.uniform(-1.0, 1.0, size=cj.n)
        for got, want in zip(ct.assemble(v, v_prev, 1e-3, t),
                             cj.assemble(v, v_prev, 1e-3, t)):
            assert got.tobytes() == want.tobytes()
    for got, want in zip(ct.assemble_ac(v, [10.0, 1e3]),
                         cj.assemble_ac(v, [10.0, 1e3])):
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", list(CASES))
def test_transient_matches_reference(reference, name):
    build, kw = CASES[name]
    want = _reference(reference, name)
    got = tcirc.transient(build(tcirc), device="cpu", **kw)
    np.testing.assert_allclose(got.voltages, want.voltages, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.newton_iters, want.newton_iters)
    assert got.n_factorizations == want.n_factorizations \
        == got.newton_iters.sum()
    assert got.ladder_counts == want.ladder_counts
    assert got.n_rescalings == want.n_rescalings
    assert got.n_full_rebuilds == want.n_full_rebuilds
    assert got.max_residual < 1e-8 and np.isfinite(got.voltages).all()


def test_transient_on_prebuilt_glu(reference):
    """A caller's GLU drives the loop and is never swapped out."""
    from repro_torch import GLU
    from repro_torch.sparse import CSC

    build, kw = CASES["grid4x4"]
    ckt = build(tcirc)
    pat = ckt.pattern()
    v = np.zeros(ckt.n)
    vals0, _ = ckt.assemble(v, v, kw["dt"], 0.0)
    glu = GLU(CSC(pat.n, pat.indptr, pat.indices, vals0), device="cpu",
              refine=1)
    got = tcirc.transient(ckt, glu=glu, **kw)
    want = _reference(reference, "grid4x4")
    np.testing.assert_allclose(got.voltages, want.voltages, rtol=TOL, atol=TOL)
    assert glu.refine_converged is True
    assert got.ladder_counts["refactorize"] == got.n_factorizations


class _LinearStubCircuit:
    """Duck-typed circuit: a FIXED linear system ``A v = b`` every step
    (the harness of ``tests/test_ladder.py``)."""

    def __init__(self, A, b):
        self._pat = A
        self._vals = np.asarray(A.data, dtype=np.float64)
        self._b = np.asarray(b, dtype=np.float64)
        self.n = A.n

    def pattern(self):
        return self._pat

    def assemble(self, v, v_prev, dt, t):
        return self._vals.copy(), self._b.copy()


@pytest.fixture(scope="module")
def hard():
    """cond >= 1e10 with crushed pivots, unscaled: refinement stalls until
    the ladder re-scales (the fixture of tests/test_ladder.py:125)."""
    args = (200,)
    kw = dict(decades=12.0, tiny_pivots=8, seed=3)
    b = np.random.default_rng(5).standard_normal(200)
    return jax_ill(*args, **kw), torch_ill(*args, **kw), b


@pytest.mark.parametrize("escalation", ["ladder", "rescale", "none"])
def test_ladder_counts_match_reference_on_ill_conditioned(hard, escalation):
    Aj, At, b = hard
    kw = dict(t_end=6.0, dt=1.0, refine=2, mc64="none", newton_tol=1e-8,
              escalation=escalation)
    want = jax_transient(_LinearStubCircuit(Aj, b), **kw)
    got = tcirc.transient(_LinearStubCircuit(At, b), device="cpu", **kw)
    assert got.ladder_counts == want.ladder_counts
    assert got.n_rescalings == want.n_rescalings
    assert got.n_full_rebuilds == want.n_full_rebuilds
    assert got.n_factorizations == want.n_factorizations
    np.testing.assert_array_equal(got.newton_iters, want.newton_iters)
    scale = np.abs(want.voltages).max()
    np.testing.assert_allclose(got.voltages / scale, want.voltages / scale,
                               rtol=TOL, atol=TOL)
    if escalation == "ladder":
        assert got.ladder_counts["rescale"] == 1
        assert got.n_full_rebuilds == 1


def test_ladder_policy_matches_reference():
    """The copied ladder climbs, reports and overrides as the reference's."""
    base = dict(ordering="auto", mc64="none", static_pivot=None,
                plan_cache="default")
    lj, lt = jcirc.ladder.RefactorizationLadder(), tcirc.RefactorizationLadder()
    for step, reason in ((0, "a"), (0, "b"), (1, "c")):
        assert lt.escalate(step=step, reason=reason) == \
            lj.escalate(step=step, reason=reason)
        assert lt.glu_kwargs(base) == lj.glu_kwargs(base)
    assert not lt.can_escalate() and lt.counts == lj.counts
    assert lt.events == lj.events and lt.n_full_rebuilds == 3
    assert tcirc.RUNGS == jcirc.ladder.RUNGS
    with pytest.raises(ValueError):
        tcirc.LadderConfig(check_growth="sometimes")


def test_unknown_escalation_rejected():
    with pytest.raises(ValueError):
        tcirc.transient(_rc(tcirc), t_end=1.0, dt=0.5, escalation="bogus",
                        device="cpu")


def test_transient_default_device_is_the_card(monkeypatch):
    """With no card and no device asked for, the driver raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcirc.transient(_rc(tcirc), t_end=1.0, dt=0.5)
