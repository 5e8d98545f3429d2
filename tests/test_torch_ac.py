"""PyTorch port, the AC small-signal sweep on the CPU: ``repro_torch.circuit.
ac_sweep`` mirroring ``tests/test_ac.py`` (the RC low-pass against its
analytic answer, diode grids against scipy ``splu`` per frequency, the
one-plan contract, the refinement report, the unconverged operating-point
warning) and held against the JAX package's ``ac_sweep(use_pallas=True)``
on the same circuits: voltages to 1e-9 (the reference's tolerance for the
path), equal operating-point Newton iterations and equal ladder counts.
"""
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import repro.circuit as jcirc
import repro_torch.circuit as tcirc
from repro.core.planner import PlanCache as JaxPlanCache
from repro.core.planner import set_default_plan_cache as jax_set_plan_cache
from repro_torch.core.planner import PlanCache, set_default_plan_cache

TOL = 1e-9


def _berr(A_scipy, x, b) -> float:
    """Componentwise backward error max_i |r_i| / (|A||x| + |b|)_i."""
    r = A_scipy @ x - b
    denom = abs(A_scipy) @ np.abs(x) + np.abs(b)
    return float(np.where(denom > 0, np.abs(r) / np.where(denom > 0, denom, 1),
                          np.where(np.abs(r) > 0, np.inf, 0.0)).max())


def _grid(pkg, nx, ny, seed, node, phasor=1.0, diodes=True):
    ckt = pkg.rc_grid_circuit(nx, ny, with_diodes=diodes, seed=seed)
    ckt.add_ac_current_source(node, 0, phasor)
    return ckt


def _lowpass(pkg):
    ckt = pkg.Circuit(2)
    ckt.add_resistor(1, 0, 2.0)            # G = 0.5 S
    ckt.add_capacitor(1, 0, 1e-3)
    ckt.add_ac_current_source(0, 1, 1.0)   # 1A phasor into node 1
    return ckt


def _same_as_reference(res, ref):
    np.testing.assert_allclose(res.voltages, ref.voltages, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res.op_point, ref.op_point, rtol=TOL, atol=TOL)
    assert res.op_newton_iters == ref.op_newton_iters
    assert res.ladder_counts == ref.ladder_counts
    assert res.n_batched_factorizations == ref.n_batched_factorizations
    assert res.op_converged == ref.op_converged


def test_ac_rc_lowpass_analytic():
    """Single-node RC: V(w) = 1 / (G + jwC), exactly."""
    freqs = np.logspace(0, 4, 9)
    res = tcirc.ac_sweep(_lowpass(tcirc), freqs, device="cpu")
    v_exact = 1.0 / (0.5 + 1j * 2 * np.pi * freqs * 1e-3)
    assert res.voltages.dtype == np.complex128
    np.testing.assert_allclose(res.voltages[:, 0], v_exact, rtol=1e-12)
    _same_as_reference(res, jcirc.ac_sweep(_lowpass(jcirc), freqs,
                                           use_pallas=True))


def test_ac_sweep_matches_scipy_oracle():
    """A 4 x 4 RC/diode grid against per-frequency scipy splu, and the
    one-plan contract: one batched complex factorize+solve covers the
    sweep, at most two symbolic builds (the DC plan and the complex one),
    and a repeat sweep builds none."""
    cache = PlanCache()
    old = set_default_plan_cache(cache)
    try:
        ckt = _grid(tcirc, 4, 4, seed=2, node=1)
        freqs = np.logspace(0, 5, 7)
        res = tcirc.ac_sweep(ckt, freqs, device="cpu")
        assert res.n_batched_factorizations == 1
        assert res.max_backward_error <= 1e-10
        pat = ckt.pattern()
        vals, rhs = ckt.assemble_ac(res.op_point, freqs)
        assert vals.dtype == np.complex128 and vals.shape == (7, pat.nnz)
        for k in range(len(freqs)):
            A = sp.csc_matrix((vals[k], pat.indices, pat.indptr),
                              shape=(pat.n, pat.n))
            x_ref = spla.splu(A).solve(rhs[k])
            np.testing.assert_allclose(res.voltages[k], x_ref,
                                       rtol=1e-9, atol=1e-12)
            assert _berr(A, res.voltages[k], rhs[k]) <= 1e-10
        assert cache.stats.builds <= 2
        builds_before = cache.stats.builds
        res2 = tcirc.ac_sweep(ckt, freqs, device="cpu")
        assert cache.stats.builds == builds_before
        assert res2.plan_cache_hits == 2
        assert res2.voltages.tobytes() == res.voltages.tobytes()
    finally:
        set_default_plan_cache(old)
    jcache = JaxPlanCache()
    jold = jax_set_plan_cache(jcache)
    try:
        ref = jcirc.ac_sweep(_grid(jcirc, 4, 4, seed=2, node=1), freqs,
                             use_pallas=True)
    finally:
        jax_set_plan_cache(jold)
    _same_as_reference(res, ref)
    assert res.plan_cache_hits == ref.plan_cache_hits


def test_ac_sweep_refinement_reports_complex_berr():
    ckt = _grid(tcirc, 3, 3, seed=0, node=1, phasor=0.5 + 0.5j, diodes=False)
    res = tcirc.ac_sweep(ckt, [10.0, 1e3], refine=2, device="cpu")
    assert res.max_backward_error <= 1e-12
    assert res.voltages.shape == (2, ckt.n)
    ref = jcirc.ac_sweep(_grid(jcirc, 3, 3, seed=0, node=1,
                               phasor=0.5 + 0.5j, diodes=False),
                         [10.0, 1e3], refine=2, use_pallas=True)
    _same_as_reference(res, ref)


def test_ac_sweep_8x8_grid_matches_reference():
    """The 8 x 8 diode grid at 25 frequencies (the reference's large-grid
    case): a low-pass response within 1e-9 of the reference."""
    freqs = np.logspace(0, 6, 25)
    res = tcirc.ac_sweep(_grid(tcirc, 8, 8, seed=3, node=5), freqs,
                         device="cpu")
    assert res.max_backward_error <= 1e-10
    mag = np.abs(res.voltages[:, 4])
    assert mag[0] > mag[-1]
    ref = jcirc.ac_sweep(_grid(jcirc, 8, 8, seed=3, node=5), freqs,
                         use_pallas=True)
    _same_as_reference(res, ref)


def test_ac_sweep_static_pivot_and_eager_steps():
    """``static_pivot`` runs the complex robust path (no bump on a healthy
    grid) with the reference's voltages; ``jit_schedule=False`` gives the
    same bits as the default."""
    freqs = np.logspace(1, 5, 5)
    ckt = _grid(tcirc, 5, 5, seed=1, node=3)
    res = tcirc.ac_sweep(ckt, freqs, static_pivot=1e-10, device="cpu")
    ref = jcirc.ac_sweep(_grid(jcirc, 5, 5, seed=1, node=3), freqs,
                         static_pivot=1e-10, use_pallas=True)
    _same_as_reference(res, ref)
    assert res.max_backward_error <= 1e-10
    eager = tcirc.ac_sweep(ckt, freqs, static_pivot=1e-10, jit_schedule=False,
                           device="cpu")
    assert eager.voltages.tobytes() == res.voltages.tobytes()


def test_ac_sweep_flags_unconverged_op_point():
    """A starved DC Newton loop sets ``op_converged=False`` and warns,
    as the reference does."""
    def diode_ckt(pkg):
        ckt = pkg.Circuit(2)
        ckt.add_resistor(1, 0, 10.0)
        ckt.add_diode(1, 0)
        ckt.add_current_source(0, 1, 0.1)   # nonzero DC op: Newton iterates
        ckt.add_ac_current_source(0, 1, 1.0)
        return ckt

    with pytest.warns(RuntimeWarning, match="operating-point Newton"):
        starved = tcirc.ac_sweep(diode_ckt(tcirc), [10.0], max_newton=1,
                                 device="cpu")
    assert not starved.op_converged
    assert starved.op_newton_iters == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        healthy = tcirc.ac_sweep(diode_ckt(tcirc), [10.0], max_newton=60,
                                 device="cpu")
    assert healthy.op_converged and healthy.op_newton_iters > 1
    assert np.abs(starved.op_point - healthy.op_point).max() > 1e-3
    with pytest.warns(RuntimeWarning):
        ref = jcirc.ac_sweep(diode_ckt(jcirc), [10.0], max_newton=1,
                             use_pallas=True)
    _same_as_reference(starved, ref)
    _same_as_reference(healthy, jcirc.ac_sweep(diode_ckt(jcirc), [10.0],
                                               max_newton=60, use_pallas=True))


@pytest.mark.parametrize("option,exc", [
    (dict(layout="native"), None),
    (dict(mesh=object()), TypeError)], ids=["native", "mesh"])
def test_ac_sweep_refuses_before_planning(option, exc):
    """A ``mesh`` that is no ``SweepMesh`` raises before any planning work.
    ``layout="native"``, the reference's default complex route, runs
    (exc None): one batched factorization, the RC low-pass's analytic
    answer and the reference's native sweep to 1e-9."""
    cache = PlanCache()
    old = set_default_plan_cache(cache)
    freqs = np.logspace(0, 4, 9)
    try:
        if exc is None:
            res = tcirc.ac_sweep(_lowpass(tcirc), freqs, device="cpu",
                                 **option)
        else:
            with pytest.raises(exc):
                tcirc.ac_sweep(_lowpass(tcirc), [10.0], device="cpu", **option)
    finally:
        set_default_plan_cache(old)
    if exc is not None:
        assert cache.stats.builds == 0 and cache.stats.hits == 0
        return
    assert 1 <= cache.stats.builds <= 2 and res.n_batched_factorizations == 1
    v_exact = 1.0 / (0.5 + 1j * 2 * np.pi * freqs * 1e-3)
    np.testing.assert_allclose(res.voltages[:, 0], v_exact, rtol=1e-12)
    _same_as_reference(res, jcirc.ac_sweep(_lowpass(jcirc), freqs, **option))
