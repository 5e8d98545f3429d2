"""PyTorch port, host side: generators and planner against the JAX package.

The port carries its own copy of the numpy host code.  With the same seed
the generators give the same bytes, and the planner gives the same plan
arrays, permutations, scalings, keys and digests.
"""
import numpy as np
import pytest

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch.core as tcore
import repro_torch.sparse as tsparse
from repro_torch.convert import (
    plan_from_arrays,
    plan_to_arrays,
    symbolic_plan_from_arrays,
)

GENERATORS = [
    ("grid_laplacian", dict(nx=9, ny=7, seed=3)),
    ("rc_ladder", dict(n=60, seed=1)),
    ("circuit_jacobian", dict(n=120, avg_degree=4.0, seed=5)),
    ("circuit_jacobian", dict(n=150, avg_degree=5.0, n_rails=3,
                              pattern_asym=0.2, asym=0.3, seed=8)),
    ("asic_like", dict(n=120, seed=2)),
]


def _same_csc(a, b):
    assert a.n == b.n
    for field in ("indptr", "indices", "data"):
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field
    assert (jsparse.csc.pattern_digest(a.indptr, a.indices)
            == tsparse.pattern_digest(b.indptr, b.indices))


@pytest.mark.parametrize("name,kwargs", GENERATORS,
                         ids=[f"{g}-{i}" for i, (g, _) in enumerate(GENERATORS)])
def test_generators_same_bytes(name, kwargs):
    _same_csc(getattr(jsparse, name)(**kwargs), getattr(tsparse, name)(**kwargs))


@pytest.mark.parametrize("suite", sorted(tsparse.SUITES))
def test_suite_matrices_same_bytes(suite):
    scale = 0.04 if suite.startswith("grid") else 0.01
    _same_csc(jsparse.make_suite_matrix(suite, scale, seed=4),
              tsparse.make_suite_matrix(suite, scale, seed=4))


def test_host_helpers_match():
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 50, size=30)
    ends = starts + rng.integers(0, 6, size=30)
    np.testing.assert_array_equal(jsparse.csc.concat_ranges(starts, ends),
                                  tsparse.concat_ranges(starts, ends))
    A = tsparse.circuit_jacobian(80, seed=1)
    for x, y in zip(jsparse.csc_transpose_pattern(A.n, A.indptr, A.indices),
                    tsparse.csc_transpose_pattern(A.n, A.indptr, A.indices)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jsparse.csc_to_dense(A), tsparse.csc_to_dense(A))


def _assert_same_arrays(da, db):
    assert set(da) == set(db)
    for k in da:
        x, y = da[k], db[k]
        if isinstance(x, np.ndarray):
            assert x.shape == y.shape and np.array_equal(x, y), k
        else:
            assert x == y, k


PLAN_CASES = [
    ("circuit", lambda m: m.circuit_jacobian(150, avg_degree=4.0, seed=11), {}),
    ("grid", lambda m: m.grid_laplacian(11, 10, seed=1), {}),
    ("rails", lambda m: m.circuit_jacobian(140, avg_degree=5.0, n_rails=3,
                                           pattern_asym=0.2, seed=4), {}),
    ("asic", lambda m: m.asic_like(130, seed=6), {}),
    ("rcm-etree", lambda m: m.circuit_jacobian(120, seed=2),
     dict(ordering="rcm", symbolic="etree")),
    ("vectorized-structural", lambda m: m.circuit_jacobian(120, seed=9),
     dict(symbolic="vectorized", mc64="structural", panel_threshold=4)),
]


@pytest.mark.parametrize("name,make,opts", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_arrays_identical(name, make, opts):
    """Every FactorizePlan array, SymbolicPlan permutation, MC64 scaling,
    plan key and digest equals the reference's."""
    Aj, At = make(jsparse), make(tsparse)
    pj, sj, _ = jcore.plan_factorization(Aj, cache=None, **opts)
    pt, st, _ = tcore.plan_factorization(At, cache=None, **opts)
    _assert_same_arrays(plan_to_arrays(pj), plan_to_arrays(pt))
    assert pj.fplan.digest == pt.fplan.digest and pj.key == pt.key
    for field in ("row_perm", "Dr", "Dc"):
        np.testing.assert_array_equal(getattr(sj, field), getattr(st, field))
    assert [s.mode for s in pj.fplan.segments] == [s.mode for s in pt.fplan.segments]
    for a, b in zip(pj.fplan.segments, pt.fplan.segments):
        np.testing.assert_array_equal(a.cols, b.cols)


def test_plan_round_trip_through_arrays():
    """A reference plan carried over as arrays rebuilds into the port's
    plan types with every field intact."""
    A = jsparse.circuit_jacobian(130, avg_degree=4.0, seed=21)
    pj, _, _ = jcore.plan_factorization(A, cache=None)
    d = plan_to_arrays(pj)
    sp = symbolic_plan_from_arrays(d)
    assert isinstance(sp, tcore.SymbolicPlan)
    assert isinstance(plan_from_arrays(d), tcore.FactorizePlan)
    _assert_same_arrays(d, plan_to_arrays(sp))
    assert sp.matches_pattern(tsparse.CSC(A.n, A.indptr, A.indices, A.data))
    assert sp.fplan.num_levels == pj.fplan.num_levels
    assert sp.fplan.flops() == pj.fplan.flops()


def test_plan_cache_hits_on_same_pattern():
    A = tsparse.circuit_jacobian(100, seed=3)
    cache = tcore.PlanCache(capacity=2)
    p1, _, hit1 = tcore.plan_factorization(A, cache=cache)
    p2, _, hit2 = tcore.plan_factorization(A, cache=cache)
    assert (hit1, hit2) == (False, True) and p1 is p2
    assert cache.stats.snapshot() == dict(hits=1, misses=1, evictions=0,
                                          builds=1, disk_hits=0)
    jkey = jcore.plan_key(A.n, A.indptr, A.indices, p1.row_perm)
    assert jkey == p1.key
