"""PyTorch port, the dependency detectors: GLU1.0's U-pattern rule, GLU2.0's
double-U scan, GLU3.0's relaxed rule, the executor's exact hazard set and
``level_stats`` (paper Fig. 10), against the JAX package's functions on
the same filled patterns.

Inputs are made with numpy from seeds: ``circuit_jacobian(200,
avg_degree=6.0)`` (a structurally symmetric pattern: flat levels, a K1 run
and a dense tail) and ``circuit_jacobian(120, avg_degree=4.0,
pattern_asym=0.3)`` (an unsymmetric one, where the double-U hazards are
not U-pattern edges), through both symbolic engines.  The detectors are
integer index computations: the arrays must be equal, in the same order
and dtype (no tolerance).
"""
import numpy as np
import pytest

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch.core as tcore
import repro_torch.sparse as tsparse

DETECTORS = ("dependencies_upattern", "dependencies_doubleu",
             "dependencies_exact", "dependencies_relaxed")
MATRICES = {
    "symmetric": dict(n=200, avg_degree=6.0),
    "unsymmetric": dict(n=120, avg_degree=4.0, pattern_asym=0.3),
}
CASES = [(m, seed, eng) for m in MATRICES for seed in (0, 1, 2)
         for eng in ("gp", "vectorized")]
IDS = [f"{m}-{seed}-{eng}" for m, seed, eng in CASES]


@pytest.fixture(scope="module")
def patterns():
    """Each case's filled pattern in both packages, built once."""
    out = {}
    for m, seed, eng in CASES:
        kw = dict(MATRICES[m], seed=seed)
        out[(m, seed, eng)] = (
            jcore.symbolic_fillin(jsparse.circuit_jacobian(**kw), eng),
            tcore.symbolic_fillin(tsparse.circuit_jacobian(**kw), eng))
    return out


def _edges(src, dst):
    return set(zip(src.tolist(), dst.tolist()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("name", DETECTORS)
def test_detector_equals_reference(patterns, case, name):
    pj, pt = patterns[case]
    want = getattr(jcore, name)(pj)
    got = getattr(tcore, name)(pt)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_level_stats_equal_reference(patterns, case):
    pj, pt = patterns[case]
    want = jcore.level_stats(pj, jcore.levelize_relaxed(pj))
    got = tcore.level_stats(pt, tcore.levelize_relaxed(pt))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_edge_sets_bracket_the_exact_set(patterns, case):
    """GLU2.0's full set (U pattern and double-U) holds every exact hazard,
    the relaxed rule holds every one too, and every exact edge points
    forward.  The exact set holds every double-U edge, and on a
    structurally symmetric pattern every U-pattern edge (on an unsymmetric
    one GLU1.0 also links i -> k past the last L row of i, which no write
    of the executor joins)."""
    _, pt = patterns[case]
    exact = _edges(*tcore.dependencies_exact(pt))
    upat = _edges(*tcore.dependencies_upattern(pt))
    doubleu = _edges(*tcore.dependencies_doubleu(pt))
    relaxed = _edges(*tcore.dependencies_relaxed(pt))
    assert upat | doubleu >= exact
    assert relaxed >= exact
    assert doubleu <= exact
    if case[0] == "symmetric":
        assert upat <= exact
    assert all(s < d for s, d in exact)


@pytest.mark.parametrize("name", ["grid64", "rajat12_like"])
def test_relaxed_levels_are_the_plans(name):
    """``levelize`` on the relaxed edges gives the planner's levelization,
    and the exact set is level-forward in it."""
    A = tsparse.make_suite_matrix(name, 0.1)
    sp, _, _ = tcore.plan_factorization(A, cache=None)
    lv = tcore.levelize(sp.n, *tcore.dependencies_relaxed(sp.pattern))
    np.testing.assert_array_equal(lv.levels, sp.levelization.levels)
    np.testing.assert_array_equal(lv.order, sp.levelization.order)
    src, dst = tcore.dependencies_exact(sp.pattern)
    assert np.all(lv.levels[src] < lv.levels[dst])
    stats = tcore.level_stats(sp.pattern, lv)
    assert stats.shape == (lv.num_levels, 3)
    assert stats[:, 0].sum() == sp.n
