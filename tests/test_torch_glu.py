"""PyTorch port, the GLU facade: ``repro_torch.GLU(A, device="cpu")`` against
``repro.GLU(A, use_pallas=True)`` on the same matrix.  Solutions agree to
1e-9 (the factors agree to rounding; the solves differ only in summation
order), residuals stay below 1e-9.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro_torch
import repro_torch.core as tcore
from repro.sparse import circuit_jacobian
from repro_torch.convert import plan_to_arrays, symbolic_plan_from_arrays
from repro_torch.sparse import circuit_jacobian as torch_circuit_jacobian

TOL = 1e-9


@pytest.fixture(scope="module")
def pair():
    """circuit_jacobian(300) plans into flat, K1 and dense-tail groups."""
    A = circuit_jacobian(300, avg_degree=4.0, seed=0)
    gj = jcore.GLU(A, dtype=jnp.float64, use_pallas=True, plan_cache=None)
    gt = repro_torch.GLU(torch_circuit_jacobian(300, avg_degree=4.0, seed=0),
                         device="cpu", plan_cache=None)
    gj.factorize()
    gt.factorize()
    b = np.random.default_rng(1).normal(size=A.n)
    return A, gj, gt, b


def test_same_schedule_and_factors(pair):
    _, gj, gt, _ = pair
    steps = []
    for g in gj._factorizer._groups:   # the reference's levels, one per step
        steps += (["flat"] * g.n_levels if g.kind in ("scan", "flat")
                  else [g.kind])
    assert gt._factorizer.kinds == tuple(steps)
    assert "dense" in gt._factorizer.kinds and "pallas" in gt._factorizer.kinds
    np.testing.assert_allclose(gt.factorized_values().numpy(),
                               np.asarray(gj.factorized_values()),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("refine", [0, 2])
def test_solve_matches_reference(pair, refine):
    A, gj, gt, b = pair
    xj = gj.solve(b, refine=refine)
    xt = gt.solve(b, refine=refine)
    assert isinstance(xt, np.ndarray) and xt.dtype == np.float64
    np.testing.assert_allclose(xt, xj, rtol=TOL, atol=TOL)
    assert gt.residual(b, xt) < 1e-9
    info_j, info_t = gj.solve_info, gt.solve_info
    assert info_t["refine_iters"] == info_j["refine_iters"]
    assert info_t["host_syncs"] == info_j["host_syncs"]
    if refine:
        assert info_t["converged"] is True
        assert info_t["backward_error"] <= gt.refine_tol


def test_solve_info_keys_and_values(pair):
    _, gj, gt, b = pair
    gj.factorize()
    gt.factorize()
    gj.solve(b, refine=1)
    gt.solve(b, refine=1)
    info_j, info_t = gj.solve_info, gt.solve_info
    keys_j = set(info_j) - {"pallas_disabled_reason"}
    assert set(info_t) == keys_j | {"kernels_disabled_reason"}
    assert info_j["pallas_disabled_reason"] is None
    assert info_t["kernels_disabled_reason"] == (
        "device='cpu' runs the plain PyTorch versions of the kernels")
    for key in ("batched", "layout", "n_devices", "batch_spec",
                "n_perturbed", "n_perturbed_global", "verify_report",
                "refine_iters", "converged"):
        assert info_t[key] == info_j[key], key
    for key in ("pivot_growth", "min_diag"):
        np.testing.assert_allclose(info_t[key], info_j[key], rtol=1e-10)
    # the port's host-issued steps: one per flat level, per run of K1
    # levels and for the dense tail
    assert info_t["n_groups"] == len(gt._factorizer.step_kinds)
    assert info_t["n_dispatches"] == 1 + info_t["n_groups"]
    assert info_t["solve_dispatches"] > 0


def test_refactorize_new_values(pair):
    A, gj, gt, b = pair
    rng = np.random.default_rng(5)
    for _ in range(2):
        new = np.asarray(A.data) * rng.uniform(0.8, 1.2, size=A.nnz)
        xj = gj.factorize(new).solve(b)
        xt = gt.factorize(new).solve(b)
        np.testing.assert_allclose(xt, xj, rtol=TOL, atol=TOL)
        A_new = A.to_scipy().copy()
        A_new.data = new
        assert np.abs(A_new @ xt - b).max() / np.abs(b).max() < 1e-9


def test_from_plan_on_reference_plan(pair):
    """A reference SymbolicPlan carried over as arrays drives the port."""
    A, gj, gt, b = pair
    sp = symbolic_plan_from_arrays(plan_to_arrays(gj.symbolic_plan))
    g = repro_torch.GLU.from_plan(sp, A, device="cpu")
    assert g.plan_from_cache
    x = g.factorize().solve(b)
    np.testing.assert_allclose(x, gj.factorize().solve(b), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="pattern"):
        repro_torch.GLU.from_plan(sp, circuit_jacobian(300, seed=1), device="cpu")


def test_float32_solve():
    A = torch_circuit_jacobian(120, avg_degree=4.0, seed=2)
    g = repro_torch.GLU(A, dtype=torch.float32, device="cpu", refine=1)
    b = np.random.default_rng(2).normal(size=A.n)
    x = g.factorize().solve(b)
    assert g.factorized_values().dtype == torch.float32
    assert g.refine_tol == 4.0 * float(np.finfo(np.float32).eps)
    assert g.residual(b, x) < 1e-4


@pytest.mark.parametrize("option,exc", [
    # planar storage needs complex values; real ones are refused as in the
    # JAX package's resolve_layout
    (dict(layout="planar"), ValueError),
    # a mesh is a SweepMesh (make_sweep_mesh); anything else is refused
    (dict(mesh=object()), TypeError),
    # verify runs ("off", "plan", "full"); any other value is refused
    (dict(verify="bogus"), ValueError),
    # complex values in the native layout, the reference's default complex
    # route, run (exc None): every level a flat step, the tail on K3
    (dict(dtype=torch.complex128, layout="native"), None),
    (dict(dtype=np.complex64, layout="native"), None),
], ids=["planar", "mesh", "verify", "complex128", "complex64"])
def test_out_of_slice_options_raise(option, exc):
    A = torch_circuit_jacobian(40, seed=1)
    if exc is None:
        g = repro_torch.GLU(A, device="cpu", **option)
        b = np.random.default_rng(1).normal(size=A.n)
        x = g.factorize().solve(b, refine=1)
        assert g.solve_info["layout"] == "native" and np.iscomplexobj(x)
        assert set(g._factorizer.step_kinds) <= {"flat", "dense"}
        assert g.residual(b, x) < 1e-5
        return
    with pytest.raises(exc):
        repro_torch.GLU(A, device="cpu", **option)


@pytest.mark.parametrize("option", [dict(static_pivot=1e-10),
                                    dict(jit_schedule=False)],
                         ids=["static_pivot", "jit_schedule"])
def test_ported_options_run(pair, option):
    """``static_pivot`` and ``jit_schedule=False`` run and solve like the
    reference's defaults on a healthy matrix (no diagonal is bumped)."""
    A, gj, _, b = pair
    g = repro_torch.GLU(torch_circuit_jacobian(300, avg_degree=4.0, seed=0),
                        device="cpu", **option)
    x = g.factorize().solve(b)
    np.testing.assert_allclose(x, gj.solve(b), rtol=TOL, atol=TOL)
    info = g.solve_info
    assert info["n_perturbed"] == (0 if "static_pivot" in option else None)
    assert info["n_dispatches"] == 1 + info["n_groups"]


# the batched and many-RHS methods refuse values that are not (B, nnz), a
# solve with no batched factorization and right-hand sides not (K, n)
@pytest.mark.parametrize("method,exc", [
    ("factorize_batched", ValueError), ("solve_batched", RuntimeError),
    ("solve_multi", ValueError), ("refactorize_solve", ValueError)],
    ids=["factorize_batched", "solve_batched", "solve_multi",
         "refactorize_solve"])
def test_batched_methods_raise(method, exc):
    g = repro_torch.GLU(torch_circuit_jacobian(40, seed=1), device="cpu")
    args = {"refactorize_solve": [np.zeros((2, 40))] * 2,
            "solve_multi": [np.zeros(40)]}.get(method, [np.zeros((2, 40))])
    with pytest.raises(exc):
        getattr(g, method)(*args)


def test_rhs_pattern_raises():
    """A pattern index out of range, or a right-hand side nonzero outside
    the pattern (the pruned solve would drop it), raises."""
    g = repro_torch.GLU(torch_circuit_jacobian(40, seed=1), device="cpu")
    with pytest.raises(ValueError, match="outside rhs_pattern"):
        g.solve(np.ones(40), rhs_pattern=[0])
    with pytest.raises(ValueError, match="out of range"):
        g.solve(np.zeros(40), rhs_pattern=[40])


def test_no_silent_cpu_fallback(monkeypatch):
    """With no card and no device asked for, construction raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.GLU(torch_circuit_jacobian(40, seed=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.GLU(torch_circuit_jacobian(40, seed=1), device="cuda")


def test_dtype_guard_raises_on_narrowing(monkeypatch):
    """A float64 request the device would hold as float32 raises."""
    real_empty = torch.empty

    def narrowing_empty(*args, dtype=None, **kwargs):
        if dtype == torch.float64:
            dtype = torch.float32
        return real_empty(*args, dtype=dtype, **kwargs)

    monkeypatch.setattr(torch, "empty", narrowing_empty)
    with pytest.raises(ValueError, match="would be held as"):
        tcore.resolve_value_dtype(torch.float64, torch.device("cpu"))
    assert tcore.resolve_value_dtype(np.float32, "cpu") == torch.float32
