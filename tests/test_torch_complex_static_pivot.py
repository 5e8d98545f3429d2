"""PyTorch port, static pivoting on complex values on the CPU.

``perturb_diags`` on complex values against the reference's planar rule
(``_perturb_diags_planar_body``: magnitude by hypot, phase per plane, an
exact zero to ``(+tau, 0)``), bit for bit, with the cases of
``tests/test_ac.py``; the robust plain K1 run (``level_run_ref`` with a
real ``tau``) on complex64/complex128 against the per-level route it
replaces, bit for bit and bump for bump; ``GLU(dtype=complex128,
static_pivot=...)`` on crushed-diagonal ``ac_jacobian`` matrices against
the reference's planar Pallas path (factors to 1e-10 relative to their
largest entry, as tests/test_torch_static_pivot.py, and equal bump counts);
and its batched twin, each row bit for bit the single ``GLU``'s.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch
import repro_torch.sparse as tsparse
from repro.kernels.ops import _perturb_diags_planar_body
from repro_torch.core import TorchFactorizer
from repro_torch.core.factorize import _build_pallas_layout
from repro_torch.kernels import level_run
from repro_torch.kernels.level_update import random_level_run
from repro_torch.kernels.ops import level_update_planar_body, perturb_diags
from repro_torch.kernels.ref import level_run_ref

REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
NP = {torch.complex64: np.float32, torch.complex128: np.float64}
CDTYPES = [torch.complex128, torch.complex64]


def _planes(vals):
    return torch.view_as_real(vals).numpy()


@pytest.mark.parametrize("dtype", CDTYPES, ids=["c128", "c64"])
def test_complex_bump_rule(dtype):
    """|d| < tau becomes tau * d / |d|: a healthy diagonal is untouched, a
    tiny one keeps its phase, an exact zero (either sign) bumps to +tau, a
    real negative to -tau; bit for bit the reference's planar rule."""
    d_tiny = 1e-14 * np.exp(1j * 0.7)
    vals = np.array([3.0 + 4.0j, d_tiny, 0.0, -1e-13, 2.0 - 1.0j,
                     complex(-0.0, -0.0), 1e-20j, np.nan])
    diag = np.array([0, 1, 2, 3, 5, 6, 7])
    tau = 1e-10
    t = torch.tensor(tau, dtype=REAL[dtype])
    got, n = perturb_diags(torch.tensor(vals).to(dtype),
                           torch.from_numpy(diag), t)
    assert n.dtype == torch.int32 and int(n) == 5
    out = got.to(torch.complex128).numpy()
    rtol = 1e-12 if dtype == torch.complex128 else 1e-6
    np.testing.assert_allclose(out[0], vals[0], rtol=rtol)
    np.testing.assert_allclose(out[1], tau * np.exp(1j * 0.7), rtol=rtol)
    assert out[2] == np.float32(tau) or dtype == torch.complex128
    np.testing.assert_allclose(out[[2, 5]], np.float64(t), rtol=0)
    np.testing.assert_allclose(out[3], -np.float64(t), rtol=0)
    np.testing.assert_allclose(out[6], 1j * np.float64(t), rtol=0)
    np.testing.assert_allclose(out[4], vals[4].astype(np.complex64)
                               if dtype == torch.complex64 else vals[4],
                               rtol=0)
    assert np.isnan(out[7])
    want, want_n = _perturb_diags_planar_body(
        jnp.asarray(_planes(torch.as_tensor(vals).to(dtype))),
        jnp.asarray(diag), jnp.asarray(NP[dtype](tau)))
    assert _planes(got).tobytes() == np.asarray(want).tobytes()
    assert int(want_n) == 5


@pytest.mark.parametrize("dtype", CDTYPES, ids=["c128", "c64"])
def test_complex_bump_batched(dtype):
    """(B, n) values with a real (B,) tau: each matrix bumps against its
    own threshold, elementwise as alone."""
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(3, 40)) + 1j * rng.normal(size=(3, 40))
    vals[:, :8] *= 1e-9
    vals[1, 4] = 0.0
    vals = torch.as_tensor(vals).to(dtype)
    diag = torch.arange(0, 40, 2)
    tau = torch.tensor([1e-3, 1e-12, 1e-3], dtype=REAL[dtype])
    got, n = perturb_diags(vals.clone(), diag, tau)
    for b in range(3):
        one, nb = perturb_diags(vals[b].clone(), diag, tau[b])
        assert torch.equal(got[b], one) and int(nb) == int(n[b])
    assert n.tolist() == [4, 1, 4]


@pytest.fixture(scope="module")
def ac_case():
    """The AC matrix's plan, unscaled: its K1 run, the run's levels and the
    value array just before the run."""
    g = repro_torch.GLU(tsparse.ac_jacobian(300, avg_degree=4.0, seed=0),
                        dtype=torch.complex128, device="cpu", mc64="none",
                        plan_cache=None)
    g.factorize()
    return g.plan, g._a_vals


@pytest.mark.parametrize("dtype", CDTYPES, ids=["c128", "c64"])
def test_robust_complex_run_equals_per_level_route(ac_case, dtype):
    """The robust plain run on complex values (bumps once per level, inside
    the run, tau real) equals, bit for bit and bump for bump, the per-level
    route: bump the level's column diagonals, then the planar level step on
    the padded layout.  Diagonals are crushed by magnitude (phase kept,
    some exact zeros) so that bumps fire in several levels."""
    plan, a_vals = ac_case
    tf = TorchFactorizer(plan, dtype=dtype, device="cpu")
    run = next(g.arrays[0] for g in tf._groups if g.kind == "run")
    segs = [s for s, k in zip(plan.segments, tf.kinds) if k == "pallas"]
    before = torch.zeros(tf.nnz + 1, dtype=dtype)
    before[tf._a_scatter] = a_vals.to(dtype)
    for g in tf._groups[: tf.step_kinds.index("run")]:
        tf._step[g.kind](before, *g.arrays)
    diag = torch.from_numpy(run.host["diag"]).long()
    rng = np.random.default_rng(5)
    pick = diag[torch.from_numpy(rng.choice(len(diag), size=len(diag) // 3,
                                            replace=False))]
    before[pick] *= 1e-12
    before[pick[:4]] = 0.0
    tau = torch.tensor(1e-6, dtype=REAL[dtype])
    got, count = before.clone(), torch.zeros((), dtype=torch.int32)
    level_run_ref(got, run, tau, count)

    want, n_want, bumped_levels = before.clone(), 0, 0
    for seg in segs[: run.n_levels]:
        want, c = perturb_diags(want, torch.as_tensor(plan.diag_idx[seg.cols]),
                                tau)
        n_want += int(c)
        bumped_levels += int(c) > 0
        arrays = [torch.from_numpy(np.asarray(a)).long()
                  for a in _build_pallas_layout(plan, seg, tf.nnz)]
        arrays[4] = arrays[4].int()
        level_update_planar_body(want, *arrays)
    assert bumped_levels >= 2
    assert int(count) == n_want > 0
    assert torch.equal(got[: tf.nnz], want[: tf.nnz])
    assert bool(torch.isfinite(torch.view_as_real(got[: tf.nnz])).all())
    # the wrapper runs the plain version for CPU tensors and counts nothing
    n = level_run.launches
    again, count2 = before.clone(), torch.zeros((), dtype=torch.int32)
    level_run(again, run, tau, count2)
    assert torch.equal(again, got) and int(count2) == n_want
    assert level_run.launches == n
    with pytest.raises(ValueError, match="together"):
        level_run(before.clone(), run, tau)


@pytest.mark.parametrize("dtype", CDTYPES, ids=["c128", "c64"])
def test_robust_complex_run_on_synthetic_levels(dtype):
    """A synthetic run with diagonals crushed by magnitude in two levels,
    one an exact zero: each becomes tau times its phase ((tau, 0) for the
    zero), and the count is theirs."""
    rng = np.random.default_rng(8)
    run, vals = random_level_run(rng, [(6, 5, 9), (5, 4, 7), (4, 3, 5)],
                                 dtype, "cpu")
    h = run.host
    crushed = torch.from_numpy(np.concatenate(
        [h["diag"][h["diag_ptr"][0]:][:2], h["diag"][h["diag_ptr"][2]:][:3]]))
    phase = vals[crushed] / vals[crushed].abs()
    vals[crushed] = phase * 1e-9
    vals[crushed[2]] = 0.0
    tau = torch.tensor(1e-3, dtype=REAL[dtype])
    got, count = vals.clone(), torch.zeros((), dtype=torch.int32)
    level_run_ref(got, run, tau, count)
    assert int(count) == 5
    want = phase * tau
    want[2] = tau.item()
    tol = 1e-15 if dtype == torch.complex128 else 1e-9
    torch.testing.assert_close(got[crushed], want, rtol=0, atol=tol)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())


def _crushed_ac(pkg, case):
    """``ac_jacobian`` of the case with the diagonals of its ``crush``
    columns crushed to 1e-18 in magnitude, phase kept."""
    A = pkg.ac_jacobian(**case["matrix"])
    data = np.asarray(A.data).copy()
    for j in case["crush"]:
        k = A.value_index(j, j)
        data[k] = data[k] / abs(data[k]) * 1e-18
    return type(A)(A.n, A.indptr, A.indices, data)


# crushed diagonals at eps 1e-8, and the healthy matrix at eps 0.3 so that
# bumps fire in many levels and before K3 in the dense tail
CASES = {
    "crushed": dict(matrix=dict(n=300, avg_degree=4.0, seed=0),
                    crush=[0, 5, 17, 40, 150], eps=1e-8),
    "tail": dict(matrix=dict(n=300, avg_degree=4.5, seed=11), crush=[],
                 eps=0.3),
}


def _kw(case):
    return dict(mc64="none", static_pivot=case["eps"], plan_cache=None)


@pytest.mark.parametrize("name", list(CASES))
def test_glu_complex_static_pivot_matches_reference(name):
    """Unscaled, the crushed or small pivots are bumped in the flat levels,
    the K1 run and before K3 in the dense tail: the factors agree
    with the reference's planar Pallas path to 1e-10 relative to their
    largest entry, the bump counts exactly, the factors are finite."""
    case = CASES[name]
    gt = repro_torch.GLU(_crushed_ac(tsparse, case), dtype=torch.complex128,
                         device="cpu", **_kw(case)).factorize()
    gj = jcore.GLU(_crushed_ac(jsparse, case), dtype=jnp.complex128,
                   use_pallas=True, **_kw(case)).factorize()
    assert gj.layout.planar
    assert set(gt._factorizer.step_kinds) == {"flat", "run", "dense"}
    vt = gt.factorized_values().numpy()
    vj = np.asarray(gj.factorized_values())
    scale = np.abs(vj).max()
    np.testing.assert_allclose(vt / scale, vj / scale, rtol=1e-10, atol=1e-10)
    assert np.isfinite(vt).all()
    n_pert = gt.solve_info["n_perturbed"]
    assert n_pert == gj.solve_info["n_perturbed"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_glu_complex_static_pivot_batched_rows_equal_single(name):
    """The batched twin at B = 3: (B,) bump counts and factors, each row
    bit for bit the single GLU's on its values, and counts equal the
    reference's batched planar path."""
    case = CASES[name]
    At = _crushed_ac(tsparse, case)
    rng = np.random.default_rng(2)
    batch = np.asarray(At.data)[None] * (1 + 0.05 * rng.uniform(-1, 1,
                                                                (3, At.nnz)))
    g = repro_torch.GLU(At, dtype=torch.complex128, device="cpu", **_kw(case))
    g.factorize_batched(batch)
    n = g.solve_info["n_perturbed"]
    assert n.shape == (3,) and (n > 0).all()
    factors = g.factorized_values_batched()
    g1 = repro_torch.GLU(At, dtype=torch.complex128, device="cpu", **_kw(case))
    for b in range(3):
        g1.factorize(batch[b])
        assert g1.solve_info["n_perturbed"] == n[b]
        assert torch.equal(g1.factorized_values(), factors[b])
    gj = jcore.GLU(_crushed_ac(jsparse, case), dtype=jnp.complex128,
                   use_pallas=True, **_kw(case))
    gj.factorize_batched(batch)
    np.testing.assert_array_equal(gj.solve_info["n_perturbed"], n)
