"""PyTorch port, complex (AC) refactorize-and-solve on the CPU: the port's
planar path against the JAX package's (``dtype=complex128``,
``use_pallas=True``, Pallas kernels in interpret mode) on the same inputs,
made with numpy from a seed.

Tolerances: factors 1e-10 and solutions 1e-9 in complex128 (the two run
the same levels in the same order and differ in summation order and in
complex division: the port's flat levels and sweeps use PyTorch's complex
``/``, which scales the divisor first, where the JAX package's planar steps
use ``a·conj(b)/|b|²``); the dense planar LU 1e-12 (f64) and 1e-5 (f32,
relative) against the blocked Pallas kernel; one K1 level 1e-12.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.sparse as jsparse
import repro.sparse.layout as jlayout
import repro_torch
import repro_torch.sparse as tsparse
from repro.core.factorize import _build_pallas_layout as jax_pallas_layout
from repro.kernels import dense_lu_planar as jax_dense_lu_planar
from repro.kernels.ops import level_update_planar_body as jax_level_planar
from repro_torch.core import TorchFactorizer
from repro_torch.core.factorize import _build_pallas_layout
from repro_torch.kernels import dense_lu_planar
from repro_torch.kernels.ops import (
    add_in_rounds_,
    level_update_planar_body,
    round_order,
    spmv,
)
from repro_torch.kernels.ref import dense_lu_planar_ref, lu_backward_error

FACT_TOL, SOLVE_TOL = 1e-10, 1e-9
K3_TOL = {np.float32: 1e-5, np.float64: 1e-12}
AC_ARGS = dict(n=300, avg_degree=4.0, seed=0)


@pytest.fixture(scope="module")
def ac_pair():
    """ac_jacobian(300) in complex128 plans into flat, K1 and dense-tail
    steps; both packages factorized once."""
    A = jsparse.ac_jacobian(**AC_ARGS)
    gj = jcore.GLU(A, dtype=jnp.complex128, use_pallas=True, plan_cache=None)
    gt = repro_torch.GLU(tsparse.ac_jacobian(**AC_ARGS), dtype=torch.complex128,
                         device="cpu", plan_cache=None)
    gj.factorize()
    gt.factorize()
    rng = np.random.default_rng(1)
    b = rng.normal(size=A.n) + 1j * rng.normal(size=A.n)
    return A, gj, gt, b


def _planes(rng, N, dtype):
    a = rng.normal(size=(2, N, N))
    a[0] += N * np.eye(N)
    return a.astype(dtype)


@pytest.mark.parametrize("kwargs", [
    dict(n=120),
    AC_ARGS,
    dict(n=150, omega=3e4, avg_degree=5.0, cap_coupling=0.5, seed=7),
], ids=["default", "fixture", "wide"])
def test_ac_jacobian_same_bytes(kwargs):
    a, b = jsparse.ac_jacobian(**kwargs), tsparse.ac_jacobian(**kwargs)
    assert a.n == b.n
    for field in ("indptr", "indices", "data"):
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


@pytest.mark.parametrize("layout", ["auto", "native", "planar", "bogus"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
def test_resolve_layout_matches_reference(layout, dtype):
    try:
        want = jlayout.resolve_layout(layout, dtype)
    except ValueError:
        with pytest.raises(ValueError):
            tsparse.resolve_layout(layout, dtype)
        return
    got = tsparse.resolve_layout(layout, dtype)
    assert got.name == want.name and got.planar == want.planar
    assert torch.empty(0, dtype=got.storage_dtype).numpy().dtype == \
        want.storage_dtype
    assert got.storage_shape(7) == want.storage_shape(7)
    assert tsparse.resolve_layout(got, torch.empty(0, dtype=got.dtype).dtype) \
        == got


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_plane_helpers_match_reference(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6, 5)) + 1j * rng.normal(size=(6, 5))).astype(dtype)
    y = (rng.normal(size=(6, 5)) + 1j * rng.normal(size=(6, 5))).astype(dtype)
    xt = torch.from_numpy(x)
    px, py = tsparse.pack_planes(xt), tsparse.pack_planes(torch.from_numpy(y))
    # the plane view shares the complex tensor's memory and is the JAX
    # package's planar array, byte for byte
    assert px.data_ptr() == xt.data_ptr()
    assert px.numpy().tobytes() == np.asarray(jlayout.pack_planes(x)).tobytes()
    np.testing.assert_array_equal(tsparse.unpack_planes(px).numpy(), x)
    jx, jy = jlayout.pack_planes(x), jlayout.pack_planes(y)
    tol = 1e-6 if dtype == np.complex64 else 1e-15
    for name, got, want in (
            ("pmul", tsparse.pmul(px, py), jlayout.pmul(jx, jy)),
            ("pdiv", tsparse.pdiv(px, py), jlayout.pdiv(jx, jy)),
            ("pabs", tsparse.pabs(px), jlayout.pabs(jx))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol, err_msg=name)
    real = tsparse.pack_planes(torch.from_numpy(x.real.copy()))
    assert torch.equal(real[..., 1], torch.zeros_like(real[..., 1]))


@pytest.mark.parametrize("N", [32, 64, 96])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dense_lu_planar_ref_matches_pallas(N, dtype):
    a = _planes(np.random.default_rng(N), N, dtype)
    want = np.asarray(jax_dense_lu_planar(jnp.asarray(a), block=32,
                                          interpret=True))
    got = dense_lu_planar_ref(torch.from_numpy(a))
    assert got.dtype == torch.from_numpy(a).dtype and got.shape == (2, N, N)
    tol = K3_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the wrapper runs the plain version for CPU tensors
    assert torch.equal(dense_lu_planar(torch.from_numpy(a)), got)
    eps = np.finfo(dtype).eps
    assert lu_backward_error(torch.from_numpy(a), got) <= 4.0 * N * eps


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_backward_error_sees_a_wrong_l(dtype):
    """A wrong L entry far below the element tolerance (L's entries are
    about 1/N on these tiles) fails the complex backward error; the
    imaginary parts count (a ``.double()`` cast would drop them)."""
    N = 64
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_planes(rng, N, np.float64))
    lu = dense_lu_planar_ref(a)
    tile, lut = torch.complex(a[0], a[1]).to(dtype), \
        torch.complex(lu[0], lu[1]).to(dtype)
    eps = torch.finfo(dtype).eps
    assert lu_backward_error(tile, lut) <= 4.0 * N * eps
    assert lu_backward_error(a, lu) <= 4.0 * N * torch.finfo(torch.float64).eps
    bad = lut.clone()
    bad[40, 7] += 1e-3j               # below 5e-3, the f32 element tolerance
    assert lu_backward_error(tile, bad) > 1e-5
    bad_planes = lu.clone()
    bad_planes[1, 40, 7] += 1e-3
    assert lu_backward_error(a, bad_planes) > 1e-5


def test_level_update_planar_matches_reference(ac_pair):
    """One recorded K1 level of the fixture: the same values before it,
    the port's planar per-level step on its padded layout against the JAX
    package's (Pallas interpret)."""
    _, gj, gt, _ = ac_pair
    fz = gt._factorizer
    gi = fz.kinds.index("pallas")            # the first K1 level
    vals = torch.zeros(fz.nnz + 1, dtype=torch.complex128)
    vals[fz._a_scatter] = gt._a_vals
    for g in fz._groups[: fz.step_kinds.index("run")]:
        fz._step[g.kind](vals, *g.arrays)
    before = vals.clone()
    seg = gt.plan.segments[gi]
    arrays = [torch.from_numpy(np.asarray(a)).long()
              for a in _build_pallas_layout(gt.plan, seg, fz.nnz)]
    arrays[4] = arrays[4].int()
    got = level_update_planar_body(vals, *arrays)[: fz.nnz]
    layout = jax_pallas_layout(gj.plan, seg, fz.nnz)
    jvals = jnp.asarray(torch.view_as_real(before[: fz.nnz]).numpy())
    want = np.asarray(jlayout.unpack_planes(
        jax_level_planar(jvals, *layout, interpret=True)))
    assert not np.array_equal(want, before[: fz.nnz].numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_same_schedule_and_factors(ac_pair):
    _, gj, gt, _ = ac_pair
    steps = []
    for g in gj._factorizer._groups:   # the reference's levels, one per step
        steps += (["flat"] * g.n_levels if g.kind in ("scan", "flat")
                  else [g.kind])
    assert gt._factorizer.kinds == tuple(steps)
    assert {"flat", "pallas", "dense"} <= set(steps)
    vt = gt.factorized_values()
    assert vt.dtype == torch.complex128
    np.testing.assert_allclose(vt.numpy(), np.asarray(gj.factorized_values()),
                               rtol=FACT_TOL, atol=FACT_TOL)


@pytest.mark.parametrize("refine", [0, 2])
def test_solve_matches_reference(ac_pair, refine):
    A, gj, gt, b = ac_pair
    xj = gj.solve(b, refine=refine)
    xt = gt.solve(b, refine=refine)
    assert isinstance(xt, np.ndarray) and xt.dtype == np.complex128
    np.testing.assert_allclose(xt, xj, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    assert gt.residual(b, xt) < 1e-9
    info_j, info_t = gj.solve_info, gt.solve_info
    assert info_t["refine_iters"] == info_j["refine_iters"]
    if refine:
        assert info_t["converged"] is True
        assert info_t["backward_error"] <= gt.refine_tol


def test_solve_info_keys_and_layout(ac_pair):
    _, gj, gt, b = ac_pair
    gj.solve(b, refine=1)
    gt.solve(b, refine=1)
    info_j, info_t = gj.solve_info, gt.solve_info
    assert set(info_t) == (set(info_j) - {"pallas_disabled_reason"}) | \
        {"kernels_disabled_reason"}
    assert info_t["layout"] == info_j["layout"] == "planar"
    assert gt.layout.planar and gt.layout.storage_dtype == torch.float64
    assert gt.refine_tol == 4.0 * float(np.finfo(np.float64).eps)
    for key in ("pivot_growth", "min_diag", "backward_error"):
        np.testing.assert_allclose(info_t[key], info_j[key], rtol=1e-6,
                                   atol=1e-15, err_msg=key)


def test_complex64_solve(ac_pair):
    A, gj, _, b = ac_pair
    gt = repro_torch.GLU(tsparse.ac_jacobian(**AC_ARGS), dtype=np.complex64,
                         device="cpu", plan_cache=None)
    x = gt.factorize().solve(b, refine=1)
    assert gt.factorized_values().dtype == torch.complex64
    assert np.iscomplexobj(x) and gt.solve_info["layout"] == "planar"
    assert gt.refine_tol == 4.0 * float(np.finfo(np.float32).eps)
    assert gt.residual(b, x) < 1e-4
    np.testing.assert_allclose(x, gj.solve(b, refine=2), rtol=1e-4, atol=1e-4)


def test_native_layout_for_complex_raises():
    """Complex values in the native layout run (every level a flat step,
    tests/test_torch_native_complex.py holds them against the reference);
    the planar layout on real values still raises."""
    A = tsparse.ac_jacobian(40, seed=1)
    gn = repro_torch.GLU(A, dtype=torch.complex128, layout="native",
                         device="cpu").factorize()
    assert gn.solve_info["layout"] == "native"
    assert "layout='native'" in gn.solve_info["kernels_disabled_reason"]
    g = repro_torch.GLU(A, dtype=torch.complex128, device="cpu").factorize()
    np.testing.assert_allclose(gn.factorized_values().numpy(),
                               g.factorized_values().numpy(),
                               rtol=1e-12, atol=1e-14)
    fz = TorchFactorizer(g.plan, dtype=torch.complex64, device="cpu",
                         layout="native")
    assert set(fz.step_kinds) <= {"flat", "dense"}
    with pytest.raises(ValueError, match="planar"):
        repro_torch.GLU(tsparse.circuit_jacobian(40, seed=1), layout="planar",
                        device="cpu")


def test_complex_scatter_adds_are_sequential():
    """Complex scatter-adds run on the re/im plane views: the bits of a
    sequential loop, duplicates included."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 7, size=60)
    src = rng.normal(size=60) + 1j * rng.normal(size=60)
    want = np.full(7, 0.5 - 0.25j)
    for i, v in zip(idx, src):
        want[i] -= v
    perm, bounds = round_order(idx)
    got = add_in_rounds_(torch.full((7,), 0.5 - 0.25j, dtype=torch.complex128),
                         torch.from_numpy(idx[perm]),
                         torch.from_numpy(src[perm]), bounds, alpha=-1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.ones(60, dtype=np.complex128)
    y = spmv(torch.from_numpy(idx), torch.arange(60), torch.from_numpy(src),
             torch.from_numpy(x), 7)
    want = np.zeros(7, dtype=np.complex128)
    for i, v in zip(idx, src):
        want[i] += v
    np.testing.assert_array_equal(y.numpy(), want)


def test_k3_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        dense_lu_planar(torch.empty((2, 64, 64), dtype=torch.float64,
                                    device="meta"))


def test_complex_glu_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.GLU(tsparse.ac_jacobian(40, seed=1), dtype=torch.complex128)
