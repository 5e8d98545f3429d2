"""PyTorch port, numeric factorization: ``TorchFactorizer`` on a plan carried
over from the JAX package (``plan_from_arrays``) against the reference
``JaxFactorizer(use_pallas=True, interpret=True)`` on the same plan, and
both against the numpy oracle.  Tolerance 1e-10 in float64: the two run the
same levels in the same order (the port one level per step, the reference
with runs of levels fused into scan groups) and differ only in summation
order inside a level.
"""
import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
from repro.core.factorize import _find_dense_tail as jax_find_dense_tail
from repro.sparse import circuit_jacobian, make_suite_matrix
from repro_torch.convert import plan_from_arrays, plan_to_arrays
from repro_torch.core import (
    TorchFactorizer,
    factorize_numpy,
    factorize_numpy_fast,
    split_lu,
)
from repro_torch.core import plan_factorization as torch_plan_factorization
from repro_torch.core.factorize import _build_pallas_layout
from repro_torch.core.symbolic import FilledPattern
from repro_torch.sparse import make_suite_matrix as torch_make_suite_matrix

TOL = 1e-10


def _steps(jf):
    """The reference's schedule one level per step, as the port runs it:
    each scan or flat group spelled out as its levels, one "flat" step
    each."""
    out = []
    for g in jf._groups:
        out += ["flat"] * g.n_levels if g.kind in ("scan", "flat") else [g.kind]
    return tuple(out)


def _same_tail(tf, jf):
    """The same dense tail; the port pads it to K2's block, not to 128."""
    if jf.dense_tail_info is None:
        return tf.dense_tail_info is None
    keys = ("level_cut", "c_star", "size")
    return ({k: tf.dense_tail_info[k] for k in keys}
            == {k: jf.dense_tail_info[k] for k in keys})


def _case(A, panel_threshold=16):
    As = jcore.symbolic_fillin_gp(A)
    plan = jcore.build_plan(As, panel_threshold=panel_threshold)
    vals0 = As.filled_csc(A).data
    return dict(A=A, As=As, plan=plan, tplan=plan_from_arrays(plan_to_arrays(plan)),
                vals0=vals0, oracle=jcore.factorize_numpy(As, vals0))


@pytest.fixture(scope="module")
def sparse_case():
    """Levels only: flat and K1 groups, no dense tail."""
    return _case(circuit_jacobian(80, avg_degree=4.0, seed=11))


@pytest.fixture(scope="module")
def tail_case():
    """A fill-reducing ordering leaves a dense trailing block: flat, scan,
    K1 and dense groups (the case of tests/test_factorize.py:140)."""
    A0 = circuit_jacobian(500, avg_degree=4.0, seed=22)
    perm = jcore.fill_reducing_ordering(A0, "mindeg")
    return _case(A0.permute(perm, perm))


@pytest.fixture(scope="module")
def flat_case():
    """panel_threshold=1 sends wide levels down the flat/scan path."""
    A0 = circuit_jacobian(100, avg_degree=4.0, seed=5)
    perm = jcore.fill_reducing_ordering(A0, "rcm")
    return _case(A0.permute(perm, perm), panel_threshold=1)


def _compare(case):
    jf = jcore.JaxFactorizer(case["plan"], dtype=jnp.float64, use_pallas=True,
                             interpret=True)
    tf = TorchFactorizer(case["tplan"], dtype=torch.float64, device="cpu")
    assert tf.kinds == _steps(jf)
    assert _same_tail(tf, jf)
    assert tf.dense_tail_info is None or (
        tf.dense_tail_info["padded"] % 32 == 0
        and 0 <= tf.dense_tail_info["padded"] - tf.dense_tail_info["size"] < 32)
    a = np.asarray(case["A"].data)
    want = np.asarray(jf.factorize(a))
    got = tf.factorize(a).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, case["oracle"], rtol=TOL, atol=TOL)
    return tf, got


@pytest.mark.parametrize("name", ["sparse_case", "tail_case", "flat_case"])
def test_factors_match_reference(name, request):
    case = request.getfixturevalue(name)
    tf, got = _compare(case)
    kinds = collections.Counter(tf.kinds)
    assert kinds["pallas"] >= 1
    if name == "tail_case":
        assert kinds["dense"] == 1 and kinds["flat"] >= 2
    if name == "flat_case":
        assert kinds["flat"] >= 2
    # L U reproduces the filled matrix
    L, U = split_lu(FilledPattern(case["As"].n, case["As"].indptr,
                                  case["As"].indices, case["As"].a_scatter,
                                  "gp"), got)
    dense = (L @ U).toarray()
    np.testing.assert_allclose(dense, case["A"].to_scipy().toarray(),
                               rtol=1e-9, atol=1e-9)


def test_trash_slot_is_never_read(tail_case):
    """Every padded slot lands in vals[nnz]: poisoning it with NaN before
    the run leaves the factors unchanged."""
    tf = TorchFactorizer(tail_case["tplan"], device="cpu")
    nnz = tf.nnz
    buf = torch.zeros(nnz + 1, dtype=torch.float64)
    buf[:nnz] = torch.from_numpy(tail_case["vals0"])
    buf[nnz] = float("nan")
    got = tf._run(buf).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, tail_case["oracle"], rtol=TOL, atol=TOL)


def test_float32_factors(sparse_case):
    tf = TorchFactorizer(sparse_case["tplan"], dtype=np.float32, device="cpu")
    got = tf.factorize(np.asarray(sparse_case["A"].data))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), sparse_case["oracle"],
                               rtol=1e-3, atol=1e-4)


def test_refactorize_new_values_and_filled_entry(sparse_case):
    tf = TorchFactorizer(sparse_case["tplan"], device="cpu")
    rng = np.random.default_rng(7)
    a = np.asarray(sparse_case["A"].data) * rng.uniform(0.9, 1.1, size=sparse_case["A"].nnz)
    vals0 = np.zeros(sparse_case["plan"].nnz)
    vals0[sparse_case["plan"].a_scatter] = a
    oracle = jcore.factorize_numpy(sparse_case["As"], vals0)
    np.testing.assert_allclose(tf.factorize(a).numpy(), oracle, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tf.factorize_filled(vals0).numpy(), oracle,
                               rtol=TOL, atol=TOL)
    # one host-issued step per flat level, per run of K1 levels and for
    # the dense tail, after the entry scatter
    assert tf.last_n_dispatches == 1 + tf.n_groups == 1 + len(tf.step_kinds)
    assert tf.step_kinds.count("run") == 1 and "pallas" in tf.kinds


@pytest.mark.parametrize("opts", [dict(fuse_buckets=False), dict(fuse_levels=False),
                                  dict(dense_tail=False)],
                         ids=["no-buckets", "no-fusion", "no-dense-tail"])
def test_group_kinds_follow_reference_options(tail_case, opts):
    """However the reference groups its levels, the port runs the same
    levels in the same order: its K1 and dense steps are the reference's
    pallas and dense groups.  Only ``dense_tail`` is an option of both."""
    jf = jcore.JaxFactorizer(tail_case["plan"], dtype=jnp.float64,
                             use_pallas=True, **opts)
    tf = TorchFactorizer(tail_case["tplan"], device="cpu",
                         dense_tail=opts.get("dense_tail", True))
    assert tf.kinds == _steps(jf)
    assert tf.kinds.count("pallas") == jf._kinds.count("pallas") >= 1
    assert tf.kinds.count("dense") == jf._kinds.count("dense")
    got = tf.factorize(np.asarray(tail_case["A"].data)).numpy()
    np.testing.assert_allclose(got, tail_case["oracle"], rtol=TOL, atol=TOL)


def test_numpy_oracles_match_reference(sparse_case):
    As = sparse_case["As"]
    tAs = FilledPattern(As.n, As.indptr, As.indices, As.a_scatter, "gp")
    np.testing.assert_array_equal(factorize_numpy(tAs, sparse_case["vals0"]),
                                  sparse_case["oracle"])
    np.testing.assert_allclose(factorize_numpy_fast(tAs, sparse_case["vals0"]),
                               jcore.factorize_numpy_fast(As, sparse_case["vals0"]),
                               rtol=1e-14, atol=1e-14)


def test_grid64_schedule_counts():
    """The slice's matrix at scale 1.0, by construction only: 154 K1 levels
    in one run (one launch), 6 flat levels and one dense tail of 146
    columns padded to 160 (K2's block is 32), the reference's counts of
    pallas and dense groups on the same plan: 9 host-issued steps.  The
    padded per-level K1 layouts are sized by each level's real maxima:
    3,606,320 (D, R) slots for 1,917,578 real updates; the run layout holds
    exactly those updates, unpadded."""
    A = torch_make_suite_matrix("grid64", 1.0)
    plan, _, _ = torch_plan_factorization(A, cache=None)
    tf = TorchFactorizer(plan.fplan, device="cpu")
    kinds = collections.Counter(tf.kinds)
    assert kinds == collections.Counter(pallas=154, flat=6, dense=1)
    assert collections.Counter(tf.step_kinds) == collections.Counter(
        run=1, flat=6, dense=1)
    assert tf.n_groups == 8      # last_n_dispatches 9 after a factorization
    assert tf.dense_tail_info == dict(level_cut=160, c_star=3950, size=146,
                                      padded=160)
    nnz = plan.fplan.nnz
    k1_segs = [seg for seg, kind in zip(plan.fplan.segments, tf.kinds)
               if kind == "pallas"]
    k1 = [_build_pallas_layout(plan.fplan, seg, nnz) for seg in k1_segs]
    shapes = [a[2].shape + (a[5].shape[1],) for a in k1]
    assert max(shapes) == (905, 90, 297)
    assert max(s[1] for s in shapes) == 199 and max(s[2] for s in shapes) == 297
    assert sum(s[0] * s[1] for s in shapes) == 3_606_320
    assert sum(int((a[2] < nnz).sum()) for a in k1) == 1_917_578
    # every row holds at least one real update and every real slot is read
    for a in k1:
        assert bool((a[2][:, 0] < nnz).all())
        assert int((a[4] < a[5].shape[1]).sum()) == int((a[2] < nnz).sum())
    (run,) = [g.arrays[0] for g in tf._groups if g.kind == "run"]
    assert run.n_levels == 154 and run.n_updates == 1_917_578
    assert len(run.host["rows"]) == sum(s[0] for s in shapes)
    assert run.max_items == 905
    assert all(t.dtype == torch.int32 for t in run.tensors.values())
    jplan, _, _ = jcore.plan_factorization(make_suite_matrix("grid64", 1.0),
                                           cache=None)
    assert jplan.fplan.digest == plan.fplan.digest
    assert jax_find_dense_tail(jplan.fplan) == (160, 3950)
    jf = jcore.JaxFactorizer(jplan.fplan, dtype=jnp.float64, use_pallas=True)
    assert _steps(jf) == tf.kinds
    assert collections.Counter(jf._kinds) == collections.Counter(
        pallas=154, flat=3, scan=1, dense=1)
    assert _same_tail(tf, jf)
