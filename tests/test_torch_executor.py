"""PyTorch port, executor: the cache of built schedules
(``repro_torch.core.executor``) with the reference's ``ExecutableCache``
semantics (hits, misses, builds, evictions, capacity, ``resolve``), a
second executor on one plan building no new layout, and ``jit_schedule``
False and True giving the same bits.  On the CPU there is no CUDA graph:
both run the steps one by one; the card's tests hold the replays.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from repro_torch.core import TorchFactorizer, TorchTriangularSolver
from repro_torch.core.executor import (
    ExecutableCache,
    default_executable_cache,
    resolve_executable_cache,
    set_default_executable_cache,
)
from repro_torch.sparse import circuit_jacobian


@pytest.fixture(scope="module")
def problem():
    A = circuit_jacobian(220, avg_degree=4.0, seed=7)
    g = repro_torch.GLU(A, device="cpu", plan_cache=None)
    b = np.random.default_rng(2).standard_normal(A.n)
    return A, g.plan, b


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_lru_eviction_and_stats(impl):
    """The same sequence gives the same stats in the port and the
    reference."""
    cls = ExecutableCache if impl == "port" else jcore.ExecutableCache
    c = cls(capacity=2)
    assert c.get_or_build("a", lambda: "A") == "A"
    c.get_or_build("b", lambda: "B")
    assert c.get_or_build("a", lambda: "A2") == "A"   # hit refreshes recency
    c.get_or_build("c", lambda: "C")                  # evicts "b"
    assert "b" not in c and "a" in c and "c" in c and len(c) == 2
    assert c.keys() == ["a", "c"]
    assert c.stats.snapshot() == dict(hits=1, misses=3, builds=3, evictions=1)
    c.clear()
    assert len(c) == 0


def test_capacity_and_resolve():
    with pytest.raises(ValueError):
        ExecutableCache(capacity=0)
    private = ExecutableCache(capacity=3)
    assert resolve_executable_cache(private) is private
    assert resolve_executable_cache("default") is default_executable_cache()
    fresh = resolve_executable_cache(None)
    assert isinstance(fresh, ExecutableCache) and fresh is not private
    with pytest.raises(TypeError):
        resolve_executable_cache("private")
    old = set_default_executable_cache(private)
    try:
        assert default_executable_cache() is private
    finally:
        assert set_default_executable_cache(old) is private


def test_second_executor_builds_no_layout(problem):
    """Equal plans share one built schedule (the K1 run layouts, flat and
    dense index tensors) and one set of sweep levels; each executor keeps
    its own buffers."""
    A, plan, _ = problem
    cache = ExecutableCache(capacity=8)
    f1 = TorchFactorizer(plan, device="cpu", executable_cache=cache)
    s1 = TorchTriangularSolver(plan, device="cpu", executable_cache=cache)
    builds = cache.stats.builds
    assert builds == 2
    f2 = TorchFactorizer(plan, device="cpu", executable_cache=cache)
    s2 = TorchTriangularSolver(plan, device="cpu", executable_cache=cache)
    assert cache.stats.builds == builds and cache.stats.hits == 2
    assert f2._groups is f1._groups and s2.fwd_levels is s1.fwd_levels
    run1 = [g.arrays[0] for g in f1._groups if g.kind == "run"]
    assert run1 and run1[0] is [g.arrays[0] for g in f2._groups
                                if g.kind == "run"][0]
    assert f1.a_values.data_ptr() != f2.a_values.data_ptr()
    # another dtype is another schedule
    TorchFactorizer(plan, dtype=torch.float32, device="cpu",
                    executable_cache=cache)
    assert cache.stats.builds == builds + 1


def test_glu_objects_share_schedule_not_factors(problem):
    """Two GLUs on one plan, one default cache: the second builds nothing,
    and neither overwrites the other's factors."""
    A, _, b = problem
    cache = ExecutableCache()
    g1 = repro_torch.GLU(A, device="cpu", executable_cache=cache)
    builds = cache.stats.builds
    g2 = repro_torch.GLU(A, device="cpu", executable_cache=cache)
    assert cache.stats.builds == builds
    assert g2._factorizer._sched is g1._factorizer._sched
    x1 = g1.factorize().solve(b)
    v1 = g1.factorized_values()
    g2.factorize(np.asarray(A.data) * 2.0)
    assert torch.equal(g1.factorized_values(), v1)
    np.testing.assert_array_equal(g1.solve(b), x1)
    np.testing.assert_allclose(g2.solve(b), x1 / 2.0, rtol=1e-12, atol=1e-12)


def test_factorized_values_is_a_copy(problem):
    A, _, _ = problem
    g = repro_torch.GLU(A, device="cpu")
    v = g.factorize().factorized_values()
    g.factorize(np.asarray(A.data) * 3.0)
    assert not torch.equal(g.factorized_values(), v)
    assert torch.equal(g.factorize().factorized_values(), v)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_jit_schedule_false_and_true_same_bits(problem, dtype):
    A, _, b = problem
    on = repro_torch.GLU(A, dtype=dtype, device="cpu", jit_schedule=True)
    off = repro_torch.GLU(A, dtype=dtype, device="cpu", jit_schedule=False)
    vals = np.asarray(A.data) * np.random.default_rng(3).uniform(
        0.9, 1.1, size=A.nnz)
    assert torch.equal(on.factorize(vals).factorized_values(),
                       off.factorize(vals).factorized_values())
    assert on.solve(b).tobytes() == off.solve(b).tobytes()
    assert on.solve(b, refine=3).tobytes() == off.solve(b, refine=3).tobytes()
    assert on.solve_info["refine_iters"] == off.solve_info["refine_iters"]


def test_dispatch_counts_without_a_graph(problem):
    """With the steps one by one: the entry scatter and one per step for a
    factorization, one per level for a solve, and for a refined solve the
    solve, its residual, each sweep's solve, correction and residual, one
    read per chunk and the |A| pass after a factorization."""
    A, _, b = problem
    g = repro_torch.GLU(A, device="cpu")
    g.factorize()
    info = g.solve_info
    assert info["n_dispatches"] == 1 + info["n_groups"]
    g.solve(b)
    steps = len(g._solver.fwd_levels) + len(g._solver.bwd_levels)
    assert g.solve_info["solve_dispatches"] == steps
    g.solve(b, refine=2)
    info = g.solve_info
    assert info["host_syncs"] == 1
    assert info["solve_dispatches"] == 1 + (steps + 1) + 2 * (steps + 2) + 1
    g.solve(b, refine=2)                 # |A| is already there
    assert g.solve_info["solve_dispatches"] == info["solve_dispatches"] - 1


def test_solver_rebinds_other_inputs(problem):
    """The solver's buffers are bound to the factors it was called with;
    other factors bind anew and give their own solution."""
    A, plan, b = problem
    f = TorchFactorizer(plan, device="cpu")
    s = TorchTriangularSolver(plan, device="cpu")
    a = np.asarray(repro_torch.GLU(A, device="cpu")._A_perm.data)
    v1 = f.factorize(a).clone()
    x1 = s.solve(v1, b).clone()
    v2 = v1 * 1.0
    v2[plan.diag_idx] *= 2.0
    x2 = s.solve(v2, b).clone()
    assert not torch.equal(x1, x2)
    assert torch.equal(s.solve(v1, b), x1)
