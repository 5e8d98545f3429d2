"""PyTorch port, complex values in the native layout on the CPU: the JAX
package's default complex route (``GLU(dtype=complex128)`` with
``use_pallas`` off, or ``layout="native"``), where every level is a flat
step in complex arithmetic.  The port runs the same flat steps and its
dense tail through K3 (its plain version here).

Held against the reference's ``GLU(..., layout="native")`` on the same
plan (carried across with ``repro_torch.convert``) and its
``ac_sweep(..., layout="native")``: factors to 1e-10 relative to their
largest entry, solutions and voltages to 1e-9 (PERF.md §2; the two differ
in summation order and in the tail's pivot division, K3's
``conj(p) / |p|^2`` against complex ``/``).  Native against the port's
planar route to ``rtol=1e-12, atol=1e-14``, as ``tests/test_layout.py``
holds the reference's two layouts.  Static-pivot bump counts equal the
reference's native route's.  complex64 at the port's complex64 tolerance
(1e-4, ``tests/test_torch_complex.py``).  Inputs are ``ac_jacobian``
matrices and right-hand sides from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.circuit as jcirc
import repro.core as jcore
import repro.sparse as jsparse
import repro_torch
import repro_torch.circuit as tcirc
import repro_torch.sparse as tsparse
from repro.kernels.ops import _perturb_diags_body
from repro_torch.convert import plan_to_arrays, symbolic_plan_from_arrays
from repro_torch.core import TorchFactorizer
from repro_torch.core.triangular import TorchTriangularSolver
from repro_torch.distributed import make_sweep_mesh
from repro_torch.kernels.ops import perturb_diags

FACT_TOL, SOLVE_TOL = 1e-10, 1e-9
LAYOUT_RTOL, LAYOUT_ATOL = 1e-12, 1e-14
C64_TOL = 1e-4
MATRIX = dict(n=300, avg_degree=4.5, seed=11)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def native():
    """The reference's native GLU and the port's native and planar GLUs on
    the reference's plan, all factorized; a complex right-hand side."""
    gj = jcore.GLU(jsparse.ac_jacobian(**MATRIX), dtype=jnp.complex128,
                   layout="native", plan_cache=None).factorize()
    At = tsparse.ac_jacobian(**MATRIX)
    sp = symbolic_plan_from_arrays(plan_to_arrays(gj.symbolic_plan))
    gt = repro_torch.GLU.from_plan(sp, At, dtype=torch.complex128,
                                   layout="native", device="cpu").factorize()
    gp = repro_torch.GLU.from_plan(sp, At, dtype=torch.complex128,
                                   device="cpu").factorize()
    rng = np.random.default_rng(4)
    b = rng.normal(size=At.n) + 1j * rng.normal(size=At.n)
    return dict(gj=gj, gt=gt, gp=gp, sp=sp, At=At, b=b)


def test_schedule_and_diagnostics(native):
    """Every level a flat step, the dense tail last; the reason names the
    layout as the reference's does; ``solve_info`` says native."""
    gj, gt, gp = native["gj"], native["gt"], native["gp"]
    fz = gt._factorizer
    assert fz.layout.name == "native" and not fz.layout.planar
    assert set(fz.kinds[:-1]) == {"flat"} and fz.kinds[-1] == "dense"
    assert set(fz.step_kinds[:-1]) == {"flat"} and fz.step_kinds[-1] == "dense"
    assert fz.step_kinds.count("flat") == len(fz.kinds) - 1
    # the planar route on the same plan keeps its K1 run
    assert "run" in gp._factorizer.step_kinds
    info = gt.solve_info
    assert info["layout"] == "native" and gp.solve_info["layout"] == "planar"
    assert "layout='native'" in info["kernels_disabled_reason"]
    assert info["kernels_disabled_reason"] == fz.kernels_disabled_reason
    assert gt._solver.layout == "native" and gp._solver.layout == "planar"
    assert gj.layout.name == "native"
    ref = jcore.GLU(jsparse.ac_jacobian(**MATRIX), dtype=jnp.complex128,
                    use_pallas=True, layout="native", plan_cache=None)
    assert "layout='native'" in ref._factorizer.pallas_disabled_reason
    assert info["n_dispatches"] == 1 + info["n_groups"] == 1 + len(
        fz.step_kinds)


def test_factors_match_reference(native):
    gj, gt = native["gj"], native["gt"]
    vt = gt.factorized_values()
    assert vt.dtype == torch.complex128
    assert _rel(vt.numpy(), gj.factorized_values()) < FACT_TOL


@pytest.mark.parametrize("refine", [0, 2])
def test_solve_matches_reference(native, refine):
    gj, gt, b = native["gj"], native["gt"], native["b"]
    x = gt.solve(b, refine=refine)
    assert x.dtype == np.complex128 and np.isfinite(x).all()
    np.testing.assert_allclose(x, gj.solve(b, refine=refine),
                               rtol=SOLVE_TOL, atol=SOLVE_TOL)
    assert gt.residual(b, x) < 1e-12
    if refine:
        assert gt.refine_converged is True
        assert gt.solve_info["backward_error"] <= 1e-12


def test_native_against_planar(native):
    """The two layouts of the port agree as the reference's two do."""
    gt, gp, b = native["gt"], native["gp"], native["b"]
    np.testing.assert_allclose(gt.factorized_values().numpy(),
                               gp.factorized_values().numpy(),
                               rtol=LAYOUT_RTOL, atol=LAYOUT_ATOL)
    np.testing.assert_allclose(gt.solve(b, refine=2), gp.solve(b, refine=2),
                               rtol=LAYOUT_RTOL, atol=LAYOUT_ATOL)


def test_batched_rows_against_single_and_reference(native):
    """B = 3 on the native route: each row the single GLU's (to the last
    bits of the CPU's vectorized complex multiply), and the reference's
    batched native solve to 1e-9."""
    gj, sp, At, b = native["gj"], native["sp"], native["At"], native["b"]
    rng = np.random.default_rng(6)
    vals = np.asarray(At.data)[None] * (1 + 0.05 * rng.uniform(-1, 1,
                                                               (3, At.nnz)))
    rhs = np.stack([b, 2 * b, 1j * b])
    g = repro_torch.GLU.from_plan(sp, At, dtype=torch.complex128,
                                  layout="native", device="cpu")
    x = g.refactorize_solve(vals, rhs, refine=1)
    assert x.shape == (3, At.n) and g.solve_info["layout"] == "native"
    fb = g.factorized_values_batched()
    g1 = repro_torch.GLU.from_plan(sp, At, dtype=torch.complex128,
                                   layout="native", device="cpu")
    for k in range(3):
        g1.factorize(vals[k])
        np.testing.assert_allclose(fb[k].numpy(),
                                   g1.factorized_values().numpy(),
                                   rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(x[k], g1.solve(rhs[k], refine=1),
                                   rtol=1e-13, atol=1e-15)
    gj.factorize_batched(vals)
    xj = gj.solve_batched(rhs, refine=1)
    gj.factorize()          # the fixture's single factorization again
    np.testing.assert_allclose(x, xj, rtol=SOLVE_TOL, atol=SOLVE_TOL)


def test_pruned_and_many_rhs(native):
    """``rhs_pattern`` and ``solve_multi`` on the native factors: the
    pruned solve is the full solve with exact zeros off the reach, each
    row of the many-RHS solve one single solve, both against the
    reference's native route."""
    gj, gt = native["gj"], native["gt"]
    n = gt.n
    b = np.zeros(n, dtype=np.complex128)
    b[[3, 200]] = [1.0 - 0.5j, 2.0j]
    full = gt.solve(b)
    pruned = gt.solve(b, rhs_pattern=[3, 200])
    np.testing.assert_allclose(pruned, full, rtol=1e-14, atol=1e-300)
    np.testing.assert_allclose(pruned, gj.solve(b, rhs_pattern=[3, 200]),
                               rtol=SOLVE_TOL, atol=SOLVE_TOL)
    rng = np.random.default_rng(8)
    B = rng.normal(size=(4, n)) + 1j * rng.normal(size=(4, n))
    X = gt.solve_multi(B, refine=1)
    for k in range(4):
        np.testing.assert_allclose(X[k], gt.solve(B[k], refine=1),
                                   rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(X, gj.solve_multi(B, refine=1),
                               rtol=SOLVE_TOL, atol=SOLVE_TOL)


def test_sharded_batch_on_emulated_mesh(native):
    """``mesh=`` on the native route: a batch over two emulated shards
    gives the unsharded batch's rows."""
    sp, At, b = native["sp"], native["At"], native["b"]
    vals = np.stack([np.asarray(At.data), 1.5 * np.asarray(At.data)])
    rhs = np.stack([b, b])
    g = repro_torch.GLU.from_plan(sp, At, dtype=torch.complex128,
                                  layout="native",
                                  mesh=make_sweep_mesh(devices=["cpu"] * 2))
    x = g.refactorize_solve(vals, rhs)
    assert g.solve_info["n_devices"] == 2 and g.layout.name == "native"
    g1 = repro_torch.GLU.from_plan(sp, At, dtype=torch.complex128,
                                   layout="native", device="cpu")
    np.testing.assert_allclose(x, g1.refactorize_solve(vals, rhs),
                               rtol=1e-13, atol=1e-15)


def _crushed(pkg, crush):
    A = pkg.ac_jacobian(**MATRIX)
    data = np.asarray(A.data).copy()
    for j in crush:
        k = A.value_index(j, j)
        data[k] = data[k] / abs(data[k]) * 1e-18
    return type(A)(A.n, A.indptr, A.indices, data)


# crushed diagonals at eps 1e-8, and the healthy matrix at eps 0.3 so that
# bumps fire in many flat levels and before K3 in the dense tail
PIVOT_CASES = {"crushed": ([0, 5, 17, 40, 150], 1e-8), "tail": ([], 0.3)}


@pytest.mark.parametrize("name", list(PIVOT_CASES))
def test_static_pivot_matches_reference_native(name):
    """Unscaled, the small pivots bump by the reference's native rule
    before each flat level and before K3: factors to 1e-10 of their
    largest entry, bump counts equal to the reference's native route's,
    and a batch's (B,) counts row by row."""
    crush, eps = PIVOT_CASES[name]
    kw = dict(mc64="none", static_pivot=eps, plan_cache=None,
              layout="native")
    gj = jcore.GLU(_crushed(jsparse, crush), dtype=jnp.complex128,
                   **kw).factorize()
    gt = repro_torch.GLU(_crushed(tsparse, crush), dtype=torch.complex128,
                         device="cpu", **kw).factorize()
    assert not gj.layout.planar and gj._factorizer.pallas_disabled_reason
    vt = gt.factorized_values().numpy()
    assert np.isfinite(vt).all()
    assert _rel(vt, gj.factorized_values()) < FACT_TOL
    n_pert = gt.solve_info["n_perturbed"]
    assert n_pert == gj.solve_info["n_perturbed"] > 0
    At = _crushed(tsparse, crush)
    batch = np.stack([np.asarray(At.data), 0.9 * np.asarray(At.data)])
    gt.factorize_batched(batch)
    gj.factorize_batched(batch)
    np.testing.assert_array_equal(gt.solve_info["n_perturbed"],
                                  gj.solve_info["n_perturbed"])
    assert gt.solve_info["n_perturbed"][0] == n_pert


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64],
                         ids=["c128", "c64"])
def test_native_bump_rule(dtype):
    """|d| < tau becomes ``tau * d / |d|`` in complex arithmetic (an exact
    zero to +tau): the reference's ``_perturb_diags_body`` on native
    complex values, to the last bits of complex division."""
    vals = np.array([3.0 + 4.0j, 1e-14 * np.exp(1j * 0.7), 0.0, -1e-13,
                     2.0 - 1.0j, 1e-20j])
    diag = np.arange(len(vals))
    tau = 1e-10
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    got, n = perturb_diags(torch.tensor(vals).to(dtype),
                           torch.from_numpy(diag),
                           torch.tensor(tau, dtype=real), native=True)
    npd = np.complex128 if dtype == torch.complex128 else np.complex64
    want, want_n = _perturb_diags_body(
        jnp.asarray(vals.astype(npd)), jnp.asarray(diag),
        jnp.asarray(tau, dtype=jnp.float64 if dtype == torch.complex128
                    else jnp.float32))
    assert int(n) == int(want_n) == 4
    rtol = 1e-15 if dtype == torch.complex128 else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=0)
    np.testing.assert_allclose(got.numpy()[1], tau * np.exp(1j * 0.7),
                               rtol=rtol)


def test_complex64(native):
    gj, sp, At, b = native["gj"], native["sp"], native["At"], native["b"]
    g = repro_torch.GLU.from_plan(sp, At, dtype=np.complex64,
                                  layout="native", device="cpu")
    x = g.factorize().solve(b, refine=1)
    assert g.factorized_values().dtype == torch.complex64
    assert g.solve_info["layout"] == "native"
    assert g.residual(b, x) < C64_TOL
    np.testing.assert_allclose(x, gj.solve(b, refine=2), rtol=C64_TOL,
                               atol=C64_TOL)


def test_factorizer_and_solver_take_native(native):
    """``TorchFactorizer(layout="native")`` and
    ``TorchTriangularSolver(layout=...)`` directly; the solver refuses a
    layout it cannot resolve, as the reference's does."""
    gt = native["gt"]
    fz = TorchFactorizer(gt.plan, dtype=torch.complex128, device="cpu",
                         layout="native")
    vals = fz.factorize(gt._factorizer.a_values)
    assert torch.equal(vals, gt._vals)
    for bad in ("auto", "bogus"):
        with pytest.raises(ValueError, match="layout"):
            TorchTriangularSolver(gt.plan, device="cpu", layout=bad)


def _ac_grid(pkg):
    ckt = pkg.rc_grid_circuit(4, 4, with_diodes=True, seed=2)
    ckt.add_ac_current_source(1, 0, 1.0)
    return ckt


@pytest.fixture(scope="module")
def ac_sweeps():
    freqs = np.logspace(0, 6, 13)
    ref = jcirc.ac_sweep(_ac_grid(jcirc), freqs, layout="native")
    nat = tcirc.ac_sweep(_ac_grid(tcirc), freqs, layout="native",
                         device="cpu")
    planar = tcirc.ac_sweep(_ac_grid(tcirc), freqs, device="cpu")
    return freqs, ref, nat, planar


def test_ac_sweep_native_matches_reference(ac_sweeps):
    """Voltages to 1e-9, equal Newton iterations, batched factorizations
    and ladder counts; against the planar sweep to 1e-12 of each point's
    largest voltage."""
    freqs, ref, nat, planar = ac_sweeps
    np.testing.assert_allclose(nat.voltages, ref.voltages, rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)
    assert nat.op_newton_iters == ref.op_newton_iters
    assert nat.n_batched_factorizations == ref.n_batched_factorizations == 1
    assert nat.ladder_counts == ref.ladder_counts
    assert nat.max_backward_error <= 1e-10
    scale = np.abs(planar.voltages).max(axis=1, keepdims=True)
    assert (np.abs(nat.voltages - planar.voltages) / scale).max() < 1e-12


def test_ac_sweep_native_on_mesh_and_escalation(ac_sweeps):
    """``mesh=`` and ``escalation="none"`` on the native route give the
    default sweep's voltages."""
    freqs, _, nat, _ = ac_sweeps
    mesh = tcirc.ac_sweep(_ac_grid(tcirc), freqs, layout="native",
                          mesh=make_sweep_mesh(devices=["cpu"] * 2))
    assert mesh.n_devices == 2
    np.testing.assert_allclose(mesh.voltages, nat.voltages, rtol=1e-13,
                               atol=1e-300)
    flat = tcirc.ac_sweep(_ac_grid(tcirc), freqs, layout="native",
                          escalation="none", device="cpu")
    assert flat.voltages.tobytes() == nat.voltages.tobytes()
