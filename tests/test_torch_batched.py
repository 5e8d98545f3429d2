"""PyTorch port, the batched engine on the CPU: B matrices on one plan.

The port's batched level step (K1's plain version on (B, nnz + 1) values)
against the JAX package's ``level_update_batched_body`` and
``level_update_planar_batched_body`` (Pallas interpret) on one level;
``factorize_batched``, ``solve_batched`` and ``refactorize_solve`` of the
port's ``GLU`` against the reference ``GLU`` (``use_pallas=True``) on the
same plan and values; matrix b of a batch against the port's single-matrix
result on its values, bit for bit; batched static pivoting, the per-matrix
diagnostics and the errors.  Inputs are made with numpy from seeds:
``circuit_jacobian(200, avg_degree=6)`` (flat levels, one K1 run and a
dense tail) and its complex AC twin, entries times ``1 + 0.1 U(-1, 1)``.

Tolerances: one level 1e-12 (the reference normalizes the L entries before
the products, K1 divides inside each product); factors 1e-10 and solutions
1e-9 in float64 and complex128 (the reference's own, tests/test_batched.py),
float32 factors 2e-3 and complex64 solutions 1e-4 (the same order of
summation differences at single precision).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch
import repro_torch.sparse as tsparse
from repro.core.factorize import _build_pallas_layout as jax_pallas_layout
from repro.kernels import ops as kops
from repro_torch.core.factorize import _build_run_layout
from repro_torch.kernels import dense_lu, dense_lu_planar, level_run
from repro_torch.kernels.level_update import random_level_run
from repro_torch.kernels.ops import (
    factor_stats,
    factor_stats_batched,
    masked_correction,
    perturb_diags_batched,
)
from repro_torch.kernels.ref import dense_lu_planar_ref, dense_lu_ref

B = 3
REAL = dict(n=200, avg_degree=6.0, seed=0)
FACT_TOL = {"float64": 1e-10, "float32": 2e-3, "complex128": 1e-10,
            "complex64": 2e-3}
SOLVE_TOL = {"float64": 1e-9, "float32": 1e-4, "complex128": 1e-9,
             "complex64": 1e-4}
JAX_DTYPES = {"float64": jnp.float64, "float32": jnp.float32,
              "complex128": jnp.complex128, "complex64": jnp.complex64}


def _value_batch(A, batch, seed):
    """B value vectors on A's pattern, each entry times 1 + 0.1 U(-1, 1)."""
    rng = np.random.default_rng(seed)
    return np.asarray(A.data)[None] * (
        1.0 + 0.1 * rng.uniform(-1, 1, size=(batch, A.nnz)))


def _pair(name):
    """The same matrix in both packages, the reference GLU (Pallas in
    interpret mode) and the port's on the CPU, and a value batch and
    right-hand sides (complex ones for complex values)."""
    cplx = name.startswith("complex")
    gen = "ac_jacobian" if cplx else "circuit_jacobian"
    Aj = getattr(jsparse, gen)(**REAL)
    At = getattr(tsparse, gen)(**REAL)
    gj = jcore.GLU(Aj, dtype=JAX_DTYPES[name], use_pallas=True,
                   plan_cache=None)
    gt = repro_torch.GLU(At, dtype=getattr(torch, name), device="cpu",
                         plan_cache=None)
    rng = np.random.default_rng(5)
    bs = rng.normal(size=(B, At.n))
    if cplx:
        bs = bs + 1j * rng.normal(size=(B, At.n))
    return dict(A=At, gj=gj, gt=gt, batch=_value_batch(At, B, seed=1), bs=bs)


@pytest.fixture(scope="module")
def cases():
    """dtype name -> the pair of GLUs, factorized batched once each."""
    out = {}
    for name in ("float64", "float32", "complex128", "complex64"):
        c = _pair(name)
        c["want"] = np.asarray(c["gj"].factorize_batched(
            c["batch"]).factorized_values_batched())
        c["got"] = c["gt"].factorize_batched(c["batch"]) \
            .factorized_values_batched()
        out[name] = c
    return out


def test_schedule_has_every_step_kind(cases):
    for c in cases.values():
        assert set(c["gt"]._factorizer.step_kinds) == {"flat", "run", "dense"}


@pytest.mark.parametrize("name", ["float64", "complex128"],
                         ids=["real", "planar"])
def test_batched_level_step_matches_reference(cases, name):
    """One K1 level for the batch, from the same values before it: the
    port's plain K1 on (B, nnz + 1) values against the reference's batched
    level step (planar: (B, nnz, 2) planes) on its padded layout."""
    c = cases[name]
    gt, gj = c["gt"], c["gj"]
    fz = gt._factorizer
    vals = torch.zeros((B, fz.nnz + 1), dtype=fz.dtype)
    vals[:, fz._a_scatter] = torch.as_tensor(gt._scaled(c["batch"]),
                                             dtype=fz.dtype)
    for g in fz._groups[: fz.step_kinds.index("run")]:
        fz._step[g.kind](vals, *g.arrays)
    before = vals[:, : fz.nnz].clone()
    seg = gt.plan.segments[fz.kinds.index("pallas")]
    run = _build_run_layout(gt.plan, [seg], "cpu")
    got = level_run(vals, run)[:, : fz.nnz]
    layout = jax_pallas_layout(gj.plan, seg, fz.nnz)
    if fz.dtype.is_complex:
        jv = jnp.asarray(torch.view_as_real(before).numpy())
        want = kops.level_update_planar_batched_body(jv, *layout,
                                                     interpret=True)
        want = np.asarray(want[..., 0]) + 1j * np.asarray(want[..., 1])
    else:
        want = np.asarray(kops.level_update_batched_body(
            jnp.asarray(before.numpy()), *layout, interpret=True))
    assert want.shape == (B, fz.nnz)
    assert not np.array_equal(want, before.numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["float64", "float32", "complex128",
                                  "complex64"])
def test_factorize_batched_matches_reference(cases, name):
    c = cases[name]
    got, want = c["got"], c["want"]
    assert got.shape == (B, c["gt"].nnz_filled) and got.dtype == getattr(
        torch, name)
    tol = FACT_TOL[name]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    info = c["gt"].solve_info
    assert info["batched"] is True and info["n_dispatches"] == \
        1 + info["n_groups"]


@pytest.mark.parametrize("name", ["float64", "float32", "complex128",
                                  "complex64"])
def test_batch_rows_equal_single_factorize(cases, name):
    """Matrix b of the batch comes out bit for bit as the port's
    single-matrix factorization of its values: the same steps and sums."""
    c = cases[name]
    g = repro_torch.GLU(c["A"], dtype=getattr(torch, name), device="cpu",
                        plan_cache=None)
    for b in range(B):
        single = g.factorize(c["batch"][b]).factorized_values()
        assert torch.equal(c["got"][b], single), b


@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("name", ["float64", "complex128"])
def test_solve_batched_matches_reference(cases, name, refine):
    c = cases[name]
    gt, gj = c["gt"], c["gj"]
    gt.factorize_batched(c["batch"])
    gj.factorize_batched(c["batch"])
    xt = gt.solve_batched(c["bs"], refine=refine)
    xj = gj.solve_batched(c["bs"], refine=refine)
    assert xt.shape == (B, gt.n)
    np.testing.assert_allclose(xt, xj, rtol=SOLVE_TOL[name],
                               atol=SOLVE_TOL[name])
    it, ij = gt.solve_info, gj.solve_info
    np.testing.assert_array_equal(it["refine_iters"], ij["refine_iters"])
    assert it["refine_iters"].shape == (B,)
    if refine:
        np.testing.assert_array_equal(it["converged"], ij["converged"])
        assert it["converged"].all() and it["host_syncs"] == 1
        assert (it["backward_error"] <= gt.refine_tol).all()
    for b in range(B):
        Ab = c["A"].to_scipy()
        Ab.data = c["batch"][b]
        assert np.abs(Ab @ xt[b] - c["bs"][b]).max() < 1e-9


@pytest.mark.parametrize("name", ["float32", "complex64"])
def test_solve_batched_single_precision(cases, name):
    c = cases[name]
    c["gt"].factorize_batched(c["batch"])
    xt = c["gt"].solve_batched(c["bs"], refine=1)
    xj = cases["complex128" if name == "complex64" else "float64"]["gj"] \
        .factorize_batched(c["batch"]).solve_batched(c["bs"], refine=2)
    np.testing.assert_allclose(xt, xj, rtol=SOLVE_TOL[name],
                               atol=SOLVE_TOL[name])


@pytest.mark.parametrize("refine", [0, 2])
def test_batch_solve_rows_equal_single_solve(cases, refine):
    """Unrefined and refined, solution b of the batch equals the port's
    single solve on matrix b's factors bit for bit."""
    c = cases["float64"]
    gt = c["gt"]
    xs = gt.factorize_batched(c["batch"]).solve_batched(c["bs"],
                                                        refine=refine)
    iters = gt.solve_info["refine_iters"]
    g = repro_torch.GLU(c["A"], device="cpu", plan_cache=None)
    for b in range(B):
        x = g.factorize(c["batch"][b]).solve(c["bs"][b], refine=refine)
        assert x.tobytes() == xs[b].tobytes(), b
        assert g.solve_info["refine_iters"] == iters[b]


def test_refactorize_solve_fused_and_single_collapse(cases):
    c = cases["float64"]
    A, batch, bs = c["A"], c["batch"], c["bs"]
    g = repro_torch.GLU(A, device="cpu", plan_cache=None, refine=2)
    fused = g.refactorize_solve(batch, bs)
    staged = g.factorize_batched(batch).solve_batched(bs)
    assert fused.tobytes() == staged.tobytes()
    # the single-matrix form: (n,) out, scalar diagnostics, a usable
    # unbatched factorization left behind
    x1 = g.refactorize_solve(batch[0], bs[0])
    assert x1.shape == (A.n,) and x1.tobytes() == fused[0].tobytes()
    info = g.solve_info
    assert info["batched"] is False
    assert isinstance(info["backward_error"], float)
    assert isinstance(info["converged"], bool)
    assert isinstance(info["refine_iters"], int)
    assert isinstance(info["pivot_growth"], float)
    assert g.solve(bs[0]).tobytes() == x1.tobytes()
    assert torch.equal(g.factorized_values(), g.factorized_values_batched()[0])
    gj = c["gj"]
    xj = gj.refactorize_solve(batch[0], bs[0], refine=2)
    np.testing.assert_allclose(x1, xj, rtol=1e-9, atol=1e-9)


def test_batched_diagnostics_match_reference(cases):
    """(B,) pivot growth and smallest diagonal, as the reference's
    ``factor_stats_batched`` gives them."""
    c = cases["float64"]
    c["gt"].factorize_batched(c["batch"])
    c["gj"].factorize_batched(c["batch"])
    it, ij = c["gt"].solve_info, c["gj"].solve_info
    assert it["batched"] is True and it["n_perturbed"] is None
    for key in ("pivot_growth", "min_diag"):
        assert it[key].shape == (B,)
        np.testing.assert_allclose(it[key], ij[key], rtol=1e-10)


def test_batched_static_pivot_counts_per_matrix():
    """One tiny-pivot matrix and one healthy one in a batch (the
    reference's tests/test_robustness.py case): the (B,) bump counts tell
    them apart, equal the reference's, and each row is the port's single
    robust factorization bit for bit."""
    kw = dict(n=80, avg_degree=3.5, seed=9)
    Aj, At = jsparse.circuit_jacobian(**kw), tsparse.circuit_jacobian(**kw)
    healthy = np.asarray(At.data).copy()
    sick = healthy.copy()
    sick[At.value_index(0, 0)] = 1e-300
    batch = np.stack([sick, healthy, sick * 1.01])
    opts = dict(mc64="none", ordering="none", static_pivot=1e-10,
                plan_cache=None)
    gj = jcore.GLU(Aj, dtype=jnp.float64, use_pallas=True, **opts)
    gt = repro_torch.GLU(At, device="cpu", **opts)
    gj.factorize_batched(batch)
    gt.factorize_batched(batch)
    nj, nt = gj.solve_info["n_perturbed"], gt.solve_info["n_perturbed"]
    assert nt.dtype == np.int32 and nt.shape == (3,)
    np.testing.assert_array_equal(nt, nj)
    assert nt[0] >= 1 and nt[1] == 0 and nt[2] == nt[0]
    got = gt.factorized_values_batched()
    # relative to each matrix's largest entry: a bumped pivot of
    # eps * max|A| makes entries of about 1/eps (as tests/
    # test_torch_static_pivot.py compares them)
    want = np.asarray(gj.factorized_values_batched())
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=1e-10,
                               atol=1e-10)
    g1 = repro_torch.GLU(At, device="cpu", **opts)
    for b in range(3):
        assert torch.equal(got[b], g1.factorize(batch[b]).factorized_values())
        assert g1.solve_info["n_perturbed"] == nt[b]


def test_batched_errors(cases):
    c = cases["float64"]
    A, batch, bs = c["A"], c["batch"], c["bs"]
    g = repro_torch.GLU(A, device="cpu", plan_cache=None)
    with pytest.raises(RuntimeError, match="factorize_batched"):
        g.solve_batched(bs)
    with pytest.raises(ValueError):
        g.factorize_batched(np.asarray(A.data))          # rank 1
    with pytest.raises(ValueError):
        g.factorize_batched(batch[:, :-1])               # not nnz wide
    g.factorize_batched(batch)
    with pytest.raises(ValueError, match="does not match"):
        g.solve_batched(bs[:2])
    with pytest.raises(ValueError):
        g.solve_batched(bs[0])                           # rank 1
    with pytest.raises(RuntimeError, match="batched"):
        g.solve(bs[0])
    with pytest.raises(ValueError, match="outside rhs_pattern"):
        g.solve_batched(bs, rhs_pattern=[0])        # bs is dense
    with pytest.raises(RuntimeError, match="batched"):
        g.solve_multi(bs)          # needs a single-matrix factorization
    with pytest.raises(ValueError):
        g._solver.solve_batched(g._vals_batch, bs[:2])


def test_batch_size_changes_between_calls(cases):
    """A new B binds new buffers; every call's rows equal the single
    results, and returning to an earlier B gives the same bits again."""
    c = cases["float64"]
    g = repro_torch.GLU(c["A"], device="cpu", plan_cache=None)
    first = g.factorize_batched(c["batch"]).factorized_values_batched()
    x3 = g.solve_batched(c["bs"])
    two = g.factorize_batched(c["batch"][1:]).factorized_values_batched()
    x2 = g.solve_batched(c["bs"][1:])
    assert torch.equal(two, first[1:]) and x2.tobytes() == x3[1:].tobytes()
    one = g.factorize_batched(c["batch"][:1]).factorized_values_batched()
    assert torch.equal(one, first[:1])
    again = g.factorize_batched(c["batch"]).factorized_values_batched()
    assert torch.equal(again, first)
    assert g.solve_batched(c["bs"]).tobytes() == x3.tobytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_perturb_diags_batched_matches_reference(dtype):
    """Per-matrix tau, (B,) counts: the reference's vmapped bump, bit for
    bit."""
    rng = np.random.default_rng(2)
    vals = rng.uniform(-1.0, 1.0, size=(3, 64)).astype(dtype)
    diag = np.arange(0, 64, 2)
    vals[0, diag[:4]] = [1e-12, -1e-12, 0.0, -0.0]
    vals[2, diag[5:7]] = [1e-5, -2e-4]
    tau = np.array([1e-3, 1e-9, 1e-3], dtype=dtype)
    want, want_n = kops.perturb_diags_batched(jnp.asarray(vals),
                                              jnp.asarray(diag),
                                              jnp.asarray(tau))
    got, got_n = perturb_diags_batched(torch.from_numpy(vals.copy()),
                                       torch.from_numpy(diag),
                                       torch.from_numpy(tau))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert got_n.dtype == torch.int32
    assert got_n.tolist() == np.asarray(want_n).tolist() == [4, 0, 2]


def test_factor_stats_and_masked_correction_batched():
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.normal(size=(3, 10)))
    diag = torch.tensor([0, 4, 9])
    a_max = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    growth, min_diag = factor_stats_batched(vals, diag, a_max)
    for b in range(3):
        g1, m1 = factor_stats(vals[b], diag, a_max[b])
        assert growth[b] == g1 and min_diag[b] == m1
    x, d = torch.zeros(3, 4), torch.ones(3, 4)
    out = masked_correction(x, d, torch.tensor([1e-3, 1e-9, 1.0]), 1e-6)
    assert out[:, 0].tolist() == [1.0, 0.0, 1.0]


@pytest.mark.parametrize("dtype,robust", [
    (torch.float64, False), (torch.float64, True), (torch.complex128, False)],
    ids=["float64", "float64-robust", "complex128"])
def test_level_run_batch_is_per_matrix(dtype, robust):
    """K1's plain version on a (B, n) batch equals one run a matrix bit for
    bit, bump counts per matrix included (static pivoting takes real
    values); the dense LU's plain versions factor a batch tile by tile."""
    rng = np.random.default_rng(4)
    run, _ = random_level_run(rng, [(6, 9, 12), (4, 7, 12)], dtype, "cpu")
    vals = torch.stack([random_level_run(np.random.default_rng(s),
                                         [(6, 9, 12), (4, 7, 12)], dtype,
                                         "cpu")[1] for s in range(B)])
    assert vals.shape == (B, run.n_vals)
    kw, kws = {}, []
    if robust:
        diag = torch.from_numpy(run.host["diag"])
        vals[0, diag[:3]] = 1e-9
        vals[2, diag[-2:]] = -1e-9
        kw = dict(tau=torch.full((B,), 1e-3, dtype=dtype),
                  count=torch.zeros(B, dtype=torch.int32))
        kws = [dict(tau=torch.tensor(1e-3, dtype=dtype),
                    count=torch.zeros((), dtype=torch.int32))
               for _ in range(B)]
    got = level_run(vals.clone(), run, **kw)
    for b in range(B):
        one = level_run(vals[b].clone(), run, **(kws[b] if robust else {}))
        assert torch.equal(got[b], one), b
        if robust:
            assert int(kw["count"][b]) == int(kws[b]["count"])
    if robust:
        assert kw["count"].tolist() == [3, 0, 2]
    tiles = torch.from_numpy(rng.normal(size=(B, 32, 32)) + 32 * np.eye(32))
    lu = dense_lu(tiles)
    planes = torch.from_numpy(rng.normal(size=(B, 2, 32, 32)))
    planes[:, 0] += 32 * torch.eye(32, dtype=torch.float64)
    plu = dense_lu_planar(planes)
    for b in range(B):
        assert torch.equal(lu[b], dense_lu_ref(tiles[b]))
        assert torch.equal(plu[b], dense_lu_planar_ref(planes[b]))


def test_level_run_refuses_bad_batch_arguments():
    run, vals = random_level_run(np.random.default_rng(5), [(3, 4, 5)],
                                 torch.float64, "cpu")
    batch = torch.stack([vals, vals])
    tau = torch.full((2,), 1e-3, dtype=torch.float64)
    with pytest.raises(ValueError, match="tau and count"):
        level_run(batch, run, tau[:1], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="tau and count"):
        level_run(vals, run, tau, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        level_run(batch[None], run)
