"""PyTorch port, sparse and many right-hand sides on the CPU: the reach
closures, the pruned sweeps (``rhs_pattern``) and ``solve_multi`` /
``solve_refined_multi``, mirroring ``tests/test_sparse_rhs.py`` on the port
and held against the JAX package's ``GLU(use_pallas=True)`` on the same
plan (carried across with ``repro_torch.convert``).

Contracts: the reaches equal the reference's arrays exactly; a pruned
solve is the port's full solve bit for bit, with exact zeros off the
reach; a row of ``solve_multi`` is one solve bit for bit; the solutions
agree with the reference's to 1e-9 (the reference's own tolerance for
this path, tests/test_torch_glu.py), and its pruned sweeps keep the same
columns.  Inputs are ``circuit_jacobian(300, avg_degree=4.5, seed=11)``
and right-hand sides from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch
import repro_torch.sparse as tsparse
from repro.core.plan import reach_closure as jax_reach_closure
from repro_torch.convert import plan_to_arrays, symbolic_plan_from_arrays
from repro_torch.core.plan import reach_closure
from repro_torch.core.triangular import trisolve_numpy

TOL = 1e-9
MATRIX = dict(n=300, avg_degree=4.5, seed=11)
PATTERNS = [[0], [17], [3, 200, 250], list(range(0, 300, 7))]


def _one_hot(n, idx, val=1.0):
    b = np.zeros(n)
    b[np.asarray(idx)] = val
    return b


@pytest.fixture(scope="module")
def factored():
    """The reference GLU (Pallas in interpret mode) and the port's GLU on
    the reference's plan, both factorized."""
    gj = jcore.GLU(jsparse.circuit_jacobian(**MATRIX), dtype=jnp.float64,
                   use_pallas=True, plan_cache=None).factorize()
    A = tsparse.circuit_jacobian(**MATRIX)
    sp = symbolic_plan_from_arrays(plan_to_arrays(gj.symbolic_plan))
    gt = repro_torch.GLU.from_plan(sp, A, device="cpu").factorize()
    return gj, gt


# --------------------------------------------------------------------------
# reach closures
# --------------------------------------------------------------------------

def test_reach_closure_basic():
    # chain 0 -> 1 -> 2 and isolated 3: adjacency col j -> rows below
    adj_ptr = np.array([0, 1, 2, 2, 2], dtype=np.int64)
    adj_rows = np.array([1, 2], dtype=np.int64)
    for seeds, want in (([0], [0, 1, 2]), ([3], [3]), ([], [])):
        got = reach_closure(4, adj_ptr, adj_rows, seeds)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jax_reach_closure(4, adj_ptr, adj_rows, seeds))
    for bad in ([4], [-1]):
        with pytest.raises(ValueError):
            reach_closure(4, adj_ptr, adj_rows, bad)


@pytest.mark.parametrize("pattern", PATTERNS, ids=["0", "17", "three", "every7"])
def test_reaches_equal_reference(factored, pattern):
    gj, gt = factored
    fr, fj = gt.plan.fwd_reach(pattern), gj.plan.fwd_reach(pattern)
    assert fr.tobytes() == np.asarray(fj, dtype=fr.dtype).tobytes()
    br, bj = gt.plan.bwd_reach(fr), gj.plan.bwd_reach(fj)
    assert br.tobytes() == np.asarray(bj, dtype=br.dtype).tobytes()
    # superset of the seeds, sorted, and a fixed point
    assert set(pattern) <= set(fr) and np.all(np.diff(fr) > 0)
    np.testing.assert_array_equal(gt.plan.fwd_reach(fr), fr)
    np.testing.assert_array_equal(gt.plan.bwd_reach(br), br)


# --------------------------------------------------------------------------
# pruned == full, bit for bit
# --------------------------------------------------------------------------

def test_full_solve_matches_numpy_oracle(factored):
    _, gt = factored
    b = np.random.default_rng(0).standard_normal(gt.n)
    vals = gt.factorized_values()
    ours = gt._solver.solve(vals, b).numpy()
    oracle = trisolve_numpy(gt.plan, vals.numpy(), b)
    np.testing.assert_allclose(ours, oracle, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("pattern", PATTERNS, ids=["0", "17", "three", "every7"])
def test_pruned_solve_bit_identical(factored, pattern):
    """The pruned solve equals the full one on the reach and off it (exact
    zeros there), keeps only the levels that hold a reach column, and
    solves like the reference's pruned solve."""
    gj, gt = factored
    n, solver = gt.n, gt._solver
    vals = gt.factorized_values()
    rng = np.random.default_rng(1)
    b = _one_hot(n, pattern, rng.standard_normal(len(pattern)))
    full = solver.solve(vals, b).clone()
    pruned = solver.solve(vals, b, rhs_pattern=pattern).clone()
    assert torch.equal(full, pruned)
    fwd, bwd, freach, breach = solver.schedule_for_pattern(pattern)
    off = np.setdiff1d(np.arange(n), breach)
    assert bool((pruned[off] == 0).all())
    assert solver.last_n_dispatches == len(fwd) + len(bwd)
    fmask = np.zeros(n, dtype=bool)
    fmask[freach] = True
    kept = [l for l in range(len(gt.plan.fwd_ptr) - 1)
            if fmask[gt.plan.fwd_cols[gt.plan.fwd_ptr[l]:gt.plan.fwd_ptr[l + 1]]].any()]
    assert len(fwd) == len(kept) and len(fwd) <= len(solver.fwd_levels)
    # every kept forward entry reads a reach column
    for lev in fwd:
        assert fmask[lev[1].numpy()].all()
    want = np.asarray(gj._solver.solve(gj.factorized_values(), b,
                                       rhs_pattern=pattern))
    np.testing.assert_allclose(pruned.numpy(), want, rtol=TOL, atol=TOL)
    _, _, jf, jb = gj._solver.schedule_for_pattern(pattern)
    assert np.array_equal(freach, jf) and np.array_equal(breach, jb)


def test_pruned_full_pattern_is_full_solve(factored):
    _, gt = factored
    solver = gt._solver
    vals = gt.factorized_values()
    b = np.random.default_rng(2).standard_normal(gt.n)
    full = solver.solve(vals, b).clone()
    pruned = solver.solve(vals, b, rhs_pattern=np.arange(gt.n)).clone()
    assert torch.equal(full, pruned)
    # a reach of every column reuses the full sweeps themselves
    fwd, bwd, _, _ = solver.schedule_for_pattern(np.arange(gt.n))
    assert fwd is solver.fwd_levels and bwd is solver.bwd_levels


def test_sparse_schedule_cached(factored):
    """Patterns are normalized, cached (LRU, capped), shared through the
    executable cache, and an evicted pattern releases its buffers."""
    _, gt = factored
    solver = gt._solver
    solver._sparse_schedules.clear()
    e1 = solver.schedule_for_pattern([4, 9])
    e2 = solver.schedule_for_pattern(np.array([9, 4, 4]))
    assert e1 is e2 and len(solver._sparse_schedules) == 1
    vals = gt.factorized_values()
    solver.solve(vals, _one_hot(gt.n, [4, 9]), rhs_pattern=[4, 9])
    key = np.array([4, 9], dtype=np.int64).tobytes()
    assert any(s[1] == key for s in solver._bound)
    # another solver on the plan builds no new sweeps for the pattern
    other = repro_torch.core.TorchTriangularSolver(gt.plan, device="cpu")
    assert other.schedule_for_pattern([4, 9])[0] is e1[0]
    for i in range(solver.SPARSE_SCHEDULE_CAP + 5):
        solver.schedule_for_pattern([100 + i])
    assert len(solver._sparse_schedules) == solver.SPARSE_SCHEDULE_CAP
    assert not any(s[1] == key for s in solver._bound)


# --------------------------------------------------------------------------
# many right-hand sides
# --------------------------------------------------------------------------

def test_solve_multi_matches_single(factored):
    gj, gt = factored
    solver = gt._solver
    vals = gt.factorized_values()
    B = np.random.default_rng(3).standard_normal((6, gt.n))
    multi = solver.solve_multi(vals, B).clone()
    assert multi.shape == (6, gt.n)
    for k in range(6):
        assert torch.equal(multi[k], solver.solve(vals, B[k]))
    want = np.asarray(gj._solver.solve_multi(gj.factorized_values(), B))
    np.testing.assert_allclose(multi.numpy(), want, rtol=TOL, atol=TOL)


def test_solve_multi_pruned_union_pattern(factored):
    _, gt = factored
    solver = gt._solver
    vals = gt.factorized_values()
    pat = [2, 77, 140]
    B = np.zeros((3, gt.n))
    for k, j in enumerate(pat):
        B[k, j] = 1.0
    full = solver.solve_multi(vals, B).clone()
    pruned = solver.solve_multi(vals, B, rhs_pattern=pat).clone()
    assert torch.equal(full, pruned)


def test_solve_multi_shape_validation(factored):
    _, gt = factored
    vals = gt.factorized_values()
    with pytest.raises(ValueError):
        gt._solver.solve_multi(vals, np.zeros(gt.n))
    with pytest.raises(ValueError):
        gt._solver.solve_multi(vals, np.zeros((2, gt.n + 1)))
    with pytest.raises(ValueError):
        gt._solver.solve_multi(torch.stack([vals, vals]), np.zeros((2, gt.n)))


def test_solve_multi_new_k_rebinds(factored):
    """A new K binds new buffers; rows stay one solve's bits."""
    _, gt = factored
    solver = gt._solver
    vals = gt.factorized_values()
    rng = np.random.default_rng(9)
    for K in (2, 5, 2):
        B = rng.standard_normal((K, gt.n))
        multi = solver.solve_multi(vals, B).clone()
        assert multi.shape == (K, gt.n)
        assert torch.equal(multi[-1], solver.solve(vals, B[-1]))


# --------------------------------------------------------------------------
# the GLU facade: permutation mapping, validation, refinement
# --------------------------------------------------------------------------

def test_glu_solve_rhs_pattern_matches_full():
    A = tsparse.circuit_jacobian(250, avg_degree=4.0, seed=5)
    glu = repro_torch.GLU(A, device="cpu").factorize()
    b = _one_hot(A.n, [12], 2.5)
    x_full = glu.solve(b)
    x_pruned = glu.solve(b, rhs_pattern=[12])
    assert np.array_equal(x_full, x_pruned)
    assert glu.residual(b, x_pruned) < 1e-12
    # refined: pruned first solve, full-sweep corrections
    x_ref = glu.solve(b, refine=2, rhs_pattern=[12])
    assert glu.residual(b, x_ref) < 1e-12
    assert glu.solve_info["converged"]
    assert np.array_equal(x_ref, glu.solve(b, refine=2))


def test_glu_solve_multi_end_to_end():
    A = tsparse.circuit_jacobian(200, avg_degree=4.0, seed=6)
    glu = repro_torch.GLU(A, device="cpu").factorize()
    gj = jcore.GLU(jsparse.circuit_jacobian(200, avg_degree=4.0, seed=6),
                   dtype=jnp.float64, use_pallas=True).factorize()
    K = 5
    seeds = [3, 50, 120, 7, 199]
    B = np.zeros((K, A.n))
    for k, j in enumerate(seeds):
        B[k, j] = 1.0
    X = glu.solve_multi(B, rhs_pattern=seeds)
    A_sp = A.to_scipy()
    for k in range(K):
        assert np.abs(A_sp @ X[k] - B[k]).max() < 1e-10
        assert np.array_equal(X[k], glu.solve(B[k]))
    np.testing.assert_allclose(X, gj.solve_multi(B, rhs_pattern=seeds),
                               rtol=TOL, atol=TOL)
    # refined many-RHS path: (K,) info arrays, as the reference's
    Xr = glu.solve_multi(B, refine=2, rhs_pattern=seeds)
    info = glu.solve_info
    assert np.asarray(info["converged"]).all()
    assert info["backward_error"].shape == (K,) == info["refine_iters"].shape
    Xj = gj.solve_multi(B, refine=2, rhs_pattern=seeds)
    np.testing.assert_allclose(Xr, Xj, rtol=TOL, atol=TOL)
    assert info["refine_iters"].tolist() == \
        gj.solve_info["refine_iters"].tolist()
    for k in range(K):
        assert np.array_equal(Xr[k], glu.solve(B[k], refine=2))


def test_glu_rhs_pattern_validation():
    A = tsparse.circuit_jacobian(60, avg_degree=3.5, seed=7)
    glu = repro_torch.GLU(A, device="cpu").factorize()
    b = _one_hot(A.n, [4, 9])
    with pytest.raises(ValueError, match="outside rhs_pattern"):
        glu.solve(b, rhs_pattern=[4])
    with pytest.raises(ValueError, match="out of range"):
        glu.solve(b, rhs_pattern=[4, 9, A.n])
    with pytest.raises(ValueError, match="outside rhs_pattern"):
        glu.solve_multi(np.stack([b, b]), rhs_pattern=[9])
    x = glu.solve(b, rhs_pattern=[4, 9])            # exact support is fine
    assert glu.residual(b, x) < 1e-10


def test_glu_pattern_maps_through_row_permutation():
    """Patterns in the original row numbering map through the MC64 row
    permutation: the pruned solve is the full one bit for bit."""
    A = tsparse.circuit_jacobian(150, avg_degree=4.0, seed=8)
    glu = repro_torch.GLU(A, mc64="scale", device="cpu").factorize()
    assert not np.array_equal(glu.row_map, np.arange(A.n))
    b = _one_hot(A.n, [33])
    assert np.array_equal(glu.solve(b), glu.solve(b, rhs_pattern=[33]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_batched_refined_solve_with_pattern(dtype):
    """solve_batched with a union pattern: unrefined rows bit for bit the
    unpruned batched solve, refined rows within 1e-9 of the reference's
    pruned batched solve with the same iteration counts, and a single pair
    through ``refactorize_solve`` with the pattern."""
    cplx = dtype.is_complex
    gen = "ac_jacobian" if cplx else "circuit_jacobian"
    kw = dict(n=200, avg_degree=4.0, seed=3)
    A = getattr(tsparse, gen)(**kw)
    g = repro_torch.GLU(A, dtype=dtype, device="cpu", plan_cache=None)
    gj = jcore.GLU(getattr(jsparse, gen)(**kw),
                   dtype=jnp.complex128 if cplx else jnp.float64,
                   use_pallas=True, plan_cache=None)
    rng = np.random.default_rng(4)
    batch = np.asarray(A.data)[None] * (1 + 0.1 * rng.uniform(-1, 1, (3, A.nnz)))
    pat = [5, 60, 150]
    bs = np.zeros((3, A.n), dtype=np.complex128 if cplx else np.float64)
    bs[:, pat] = rng.normal(size=(3, 3))
    g.factorize_batched(batch)
    full = g.solve_batched(bs)
    pruned = g.solve_batched(bs, rhs_pattern=pat)
    assert np.array_equal(full, pruned)
    xr = g.solve_batched(bs, refine=2, rhs_pattern=pat)
    info = g.solve_info
    xj = gj.factorize_batched(batch).solve_batched(bs, refine=2,
                                                   rhs_pattern=pat)
    np.testing.assert_allclose(xr, xj, rtol=TOL, atol=TOL)
    assert info["converged"].all()
    assert info["refine_iters"].tolist() == \
        gj.solve_info["refine_iters"].tolist()
    # one pair: the batch's row bit for bit in float64; in complex128 the
    # CPU's vectorized complex multiply may round a batch row's last bit
    # differently from one matrix's (its scalar tail), so to 1e-12
    x1 = g.refactorize_solve(batch[0], bs[0], rhs_pattern=pat)
    if cplx:
        np.testing.assert_allclose(x1, full[0], rtol=1e-12, atol=1e-15)
    else:
        assert np.array_equal(x1, full[0])
