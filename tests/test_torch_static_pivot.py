"""PyTorch port, static pivoting: ``perturb_diags`` against the reference's
``_perturb_diags_body`` (same bumps, same count, bit for bit),
``GLU(static_pivot=...)`` against the reference's (factors to 1e-10,
relative, and equal bump counts), and the robust plain K1 run
(``level_run_ref`` with ``tau``) against the per-level robust route it
replaces, bit for bit, with bumps in more than one level of one run.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro_torch
from repro.kernels.ops import _perturb_diags_body
from repro.sparse import ill_conditioned_jacobian as jax_ill
from repro_torch.core import TorchFactorizer
from repro_torch.core.factorize import _build_pallas_layout
from repro_torch.kernels import level_run
from repro_torch.kernels.level_update import (
    LevelRun,
    check_run_invariants,
    random_level_run,
)
from repro_torch.kernels.ops import level_update_body, perturb_diags
from repro_torch.kernels.ref import level_run_ref
from repro_torch.sparse import ill_conditioned_jacobian as torch_ill

ILL = dict(decades=0.0, tiny_pivots=3, seed=5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_perturb_diags_matches_reference(dtype):
    """Tiny, zero (both signs), negative, NaN and healthy diagonals: the
    same bumped values and count as the reference, bit for bit."""
    rng = np.random.default_rng(1)
    vals = rng.uniform(-1.0, 1.0, size=64).astype(dtype)
    diag = np.arange(0, 64, 2)
    vals[diag[:6]] = np.array([1e-12, -1e-12, 0.0, -0.0, np.nan, 3e-4],
                              dtype=dtype)
    tau = dtype(1e-3)
    want, want_n = _perturb_diags_body(jnp.asarray(vals), jnp.asarray(diag),
                                       jnp.asarray(tau))
    got, got_n = perturb_diags(torch.from_numpy(vals.copy()),
                               torch.from_numpy(diag),
                               torch.tensor(tau))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert got_n.dtype == torch.int32 and int(got_n) == int(want_n) == 5
    assert got[4].item() == got[6].item() == float(tau)     # +tau for +-0


@pytest.mark.parametrize("kw", [dict(n=150, **ILL),
                                dict(n=200, decades=12.0, tiny_pivots=8,
                                     seed=3)],
                         ids=["decades0", "decades12"])
def test_ill_conditioned_jacobian_same_bytes(kw):
    a, b = jax_ill(**kw), torch_ill(**kw)
    for name in ("indptr", "indices", "data"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes(), name


@pytest.fixture(scope="module")
def ill():
    return jax_ill(150, **ILL), torch_ill(150, **ILL)


@pytest.mark.parametrize("mc64", ["none", "scale"])
@pytest.mark.parametrize("eps", [1e-10, 1e-3])
def test_glu_static_pivot_matches_reference(ill, mc64, eps):
    """Unscaled, the crushed pivots are bumped (2 of them); MC64 scaling
    repairs them first (0 bumps).  Factors agree to 1e-10 relative to
    their magnitude (a bumped pivot of eps * max|A| makes entries of
    1/eps), bump counts exactly, solutions to 1e-9 after refinement."""
    Aj, At = ill
    gj = jcore.GLU(Aj, dtype=jnp.float64, use_pallas=True, static_pivot=eps,
                   mc64=mc64, plan_cache=None).factorize()
    gt = repro_torch.GLU(At, device="cpu", static_pivot=eps, mc64=mc64,
                         plan_cache=None).factorize()
    vj = np.asarray(gj.factorized_values())
    vt = gt.factorized_values().numpy()
    scale = np.abs(vj).max()
    np.testing.assert_allclose(vt / scale, vj / scale, rtol=1e-10, atol=1e-10)
    assert gt.solve_info["n_perturbed"] == gj.solve_info["n_perturbed"] \
        == (2 if mc64 == "none" else 0)
    b = np.random.default_rng(2).normal(size=At.n)
    if mc64 == "scale":
        np.testing.assert_allclose(gt.solve(b, refine=2),
                                   gj.solve(b, refine=2), rtol=1e-9, atol=1e-9)
        assert gt.refine_converged is True


def test_static_pivot_complex_raises():
    """Complex static pivoting runs on the planar storage and on the native
    one (the reference's native bump rule before each flat level,
    tests/test_torch_native_complex.py); neither bumps a healthy matrix,
    and both layouts give the same factors."""
    from repro_torch.sparse import ac_jacobian

    gn = repro_torch.GLU(ac_jacobian(40), dtype=torch.complex128,
                         device="cpu", static_pivot=1e-10, layout="native",
                         plan_cache=None).factorize()
    g = repro_torch.GLU(ac_jacobian(40), dtype=torch.complex128, device="cpu",
                        static_pivot=1e-10, plan_cache=None).factorize()
    assert g.solve_info["n_perturbed"] == gn.solve_info["n_perturbed"] == 0
    np.testing.assert_allclose(gn.factorized_values().numpy(),
                               g.factorized_values().numpy(),
                               rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module")
def run_case():
    """The ill-conditioned matrix's plan, unscaled: its K1 run, the run's
    levels and the value array just before the run."""
    At = torch_ill(150, **ILL)
    g = repro_torch.GLU(At, device="cpu", mc64="none", plan_cache=None)
    tf = g._factorizer
    run = next(gr.arrays[0] for gr in tf._groups if gr.kind == "run")
    segs = [s for s, k in zip(tf.plan.segments, tf.kinds) if k == "pallas"]
    vals = torch.zeros(tf.nnz + 1, dtype=torch.float64)
    vals[tf._a_scatter] = torch.as_tensor(g._A_perm.data)
    for gr in tf._groups[: tf.step_kinds.index("run")]:
        tf._step[gr.kind](vals, *gr.arrays)
    return tf, run, segs[: run.n_levels], vals


def test_robust_run_equals_per_level_robust_route(run_case):
    """The robust plain run (bumps once per level, inside the run) equals,
    bit for bit and bump for bump, the reference's route: per level, bump
    the level's column diagonals, then the level step on the padded
    layout.  tau is set so that bumps fire in several levels."""
    tf, run, segs, before = run_case
    diag_mag = before[tf._diag_idx].abs()
    tau = torch.quantile(diag_mag, 0.3).to(torch.float64)
    got, count = before.clone(), torch.zeros((), dtype=torch.int32)
    level_run_ref(got, run, tau, count)

    want, n_want, bumped_levels = before.clone(), 0, 0
    for seg in segs:
        want, c = perturb_diags(want, torch.as_tensor(tf.plan.diag_idx[seg.cols]),
                                tau)
        n_want += int(c)
        bumped_levels += int(c) > 0
        arrays = [torch.from_numpy(np.asarray(a)).long()
                  for a in _build_pallas_layout(tf.plan, seg, tf.nnz)]
        arrays[4] = arrays[4].int()
        level_update_body(want, *arrays)
    assert bumped_levels >= 2
    assert int(count) == n_want > 0
    assert torch.equal(got[: tf.nnz], want[: tf.nnz])
    # without tau the run bumps nothing and differs
    plain = level_run_ref(before.clone(), run)
    assert not torch.equal(plain, got)
    # the wrapper runs the plain version for CPU tensors and counts nothing
    n = level_run.launches
    again, count2 = before.clone(), torch.zeros((), dtype=torch.int32)
    level_run(again, run, tau, count2)
    assert torch.equal(again, got) and int(count2) == n_want
    assert level_run.launches == n


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_robust_run_on_synthetic_levels(dtype):
    """A synthetic run with diagonals crushed below tau in two levels: each
    level bumps its own, the count is theirs, and the contributions divide
    by the bumped values."""
    rng = np.random.default_rng(8)
    run, vals = random_level_run(rng, [(6, 5, 9), (5, 4, 7), (4, 3, 5)],
                                 dtype, "cpu")
    h = run.host
    crushed = np.concatenate([h["diag"][h["diag_ptr"][0]:][:2],
                              h["diag"][h["diag_ptr"][2]:][:3]])
    vals[torch.from_numpy(crushed)] = torch.tensor(
        [1e-9, -1e-9, 0.0, 2e-9, -3e-9], dtype=dtype)
    tau = torch.tensor(1e-3, dtype=dtype)
    got, count = vals.clone(), torch.zeros((), dtype=torch.int32)
    level_run_ref(got, run, tau, count)
    assert int(count) == 5
    assert torch.equal(got[torch.from_numpy(crushed)],
                       torch.tensor([1e-3, -1e-3, 1e-3, 1e-3, -1e-3],
                                    dtype=dtype))
    assert bool(torch.isfinite(got).all())
    with pytest.raises(ValueError, match="together"):
        level_run(vals.clone(), run, tau)


def test_run_invariants_cover_the_bumped_diagonals():
    """A level that writes a diagonal it bumps breaks I2; a later level
    that writes an earlier level's bumped diagonal breaks I3."""
    run, _ = random_level_run(np.random.default_rng(4),
                              [(6, 5, 9), (5, 4, 7)], torch.float64, "cpu")
    h = {k: v.copy() for k, v in run.host.items()}
    seg0 = h["rows"][h["levels"][0, 2], 0]
    seg1 = h["rows"][h["levels"][1, 2], 0]
    for slot, which in ((seg0, "I2"), (seg1, "I3")):
        diag = h["diag"].copy()
        diag[0] = slot + h["upd"][h["rows"][h["levels"][0 if which == "I2"
                                                         else 1, 2], 2], 3]
        with pytest.raises(ValueError, match=which):
            check_run_invariants(h["levels"], h["rows"], h["upd"], h["norm"],
                                 (h["diag_ptr"], diag))
    with pytest.raises(ValueError, match="diagonal"):
        LevelRun(h["levels"][:, :6], h["rows"], h["upd"], h["norm"],
                 run.n_vals, "cpu", diag=(h["diag_ptr"][:-1], h["diag"]))


def test_factorizer_static_pivot_filled_entry(ill):
    """``factorize_filled`` runs the same robust steps as ``factorize``."""
    _, At = ill
    g = repro_torch.GLU(At, device="cpu", mc64="none", static_pivot=1e-10,
                        plan_cache=None)
    tf = TorchFactorizer(g.plan, device="cpu", static_pivot=1e-10)
    a = np.asarray(g._A_perm.data)
    v1 = tf.factorize(a).clone()
    n1 = int(tf.last_n_perturbed)
    vals0 = np.zeros(g.plan.nnz)
    vals0[g.plan.a_scatter] = a
    v2 = tf.factorize_filled(vals0)
    assert torch.equal(v1, v2) and int(tf.last_n_perturbed) == n1 == 2
