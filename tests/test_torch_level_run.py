"""PyTorch port, K1 as one launch per run of SEGMENTED/PANEL levels, on the
CPU: the run layout against the JAX package's padded per-level layouts, the
invariants that make one grid barrier a level safe, the run's plain
version against the per-level route bit for bit, and the factorizer with
the run step against the JAX package (factors 1e-10, solutions 1e-9, as in
tests/test_torch_factorize.py and tests/test_torch_complex.py).  The CUDA
kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch
import repro_torch.sparse as tsparse
from repro.core.factorize import _build_pallas_layout as jax_pallas_layout
from repro_torch.convert import plan_from_arrays, plan_to_arrays
from repro_torch.core import TorchFactorizer
from repro_torch.core import plan_factorization as torch_plan_factorization
from repro_torch.core.factorize import _build_pallas_layout, _build_run_layout
from repro_torch.kernels import level_run
from repro_torch.kernels.level_update import (
    LevelRun,
    check_run_invariants,
    random_level_run,
)
from repro_torch.kernels.ops import level_update_body, level_update_planar_body
from repro_torch.kernels.ref import level_run_ref

FACT_TOL, SOLVE_TOL = 1e-10, 1e-9


def _plan(A, panel_threshold=16):
    As = jcore.symbolic_fillin_gp(A)
    plan = jcore.build_plan(As, panel_threshold=panel_threshold)
    return plan, plan_from_arrays(plan_to_arrays(plan))


def _sparse():
    return _plan(jsparse.circuit_jacobian(80, avg_degree=4.0, seed=11))


def _tail():
    A0 = jsparse.circuit_jacobian(500, avg_degree=4.0, seed=22)
    perm = jcore.fill_reducing_ordering(A0, "mindeg")
    return _plan(A0.permute(perm, perm))


def _flat():
    A0 = jsparse.circuit_jacobian(100, avg_degree=4.0, seed=5)
    perm = jcore.fill_reducing_ordering(A0, "rcm")
    return _plan(A0.permute(perm, perm), panel_threshold=1)


def _grid64():
    A = tsparse.make_suite_matrix("grid64", 1.0)
    plan, _, _ = torch_plan_factorization(A, cache=None)
    return None, plan.fplan


@pytest.fixture(scope="module")
def plans():
    """The fixtures of tests/test_torch_factorize.py (levels only, a dense
    tail, wide levels down the flat path) and grid64 at scale 1.0:
    ``{name: (JAX plan or None, port plan)}``, built once."""
    return {}


def _get(plans, name):
    if name not in plans:
        plans[name] = {"sparse": _sparse, "tail": _tail, "flat": _flat,
                       "grid64": _grid64}[name]()
    return plans[name]


def _runs(tplan):
    """The factorizer's runs and, for each, its levels' plan segments."""
    tf = TorchFactorizer(tplan, device="cpu")
    k1 = [seg for seg, kind in zip(tplan.segments, tf.kinds)
          if kind == "pallas"]
    runs = [g.arrays[0] for g in tf._groups if g.kind == "run"]
    out, i = [], 0
    for run in runs:
        out.append((run, k1[i:i + run.n_levels]))
        i += run.n_levels
    assert i == len(k1)
    return tf, out


@pytest.mark.parametrize("name", ["sparse", "tail", "flat", "grid64"])
def test_run_layout_matches_padded_layouts(plans, name):
    """Per level: the same normalization entries; per row, the same
    destination column segment, and exactly the padded layout's real
    updates in its order, with ``ldiag`` the diagonal of each L operand's
    column; nothing else."""
    jplan, tplan = _get(plans, name)
    nnz = tplan.nnz
    tf, runs = _runs(tplan)
    assert runs and tf.step_kinds.count("run") == len(runs)
    diag_of = {int(i): int(d) for i, d in zip(tplan.norm_idx, tplan.norm_diag)}
    for run, segs in runs:
        h = run.host
        assert run.n_levels == len(segs)
        for k, seg in enumerate(segs):
            # the JAX package's own layout where there is a JAX plan
            padded = (_build_pallas_layout(tplan, seg, nnz) if jplan is None
                      else jax_pallas_layout(jplan, jplan.segments[seg.level],
                                             nnz))
            ni, nd, li, ui, dl, cp = (np.asarray(a) for a in padded)
            n0, n1, r0, r1, i0, i1 = h["levels"][k]
            np.testing.assert_array_equal(h["norm"][n0:n1, 0], ni[ni < nnz])
            np.testing.assert_array_equal(h["norm"][n0:n1, 1], nd[ni < nnz])
            rows = h["rows"][r0:r1]
            assert len(rows) == li.shape[0]
            col_len = (cp < nnz).sum(axis=1)
            np.testing.assert_array_equal(rows[:, 0], cp[:, 0])
            np.testing.assert_array_equal(rows[:, 1], col_len)
            real = li < nnz
            np.testing.assert_array_equal(rows[:, 3] - rows[:, 2], real.sum(1))
            upd = h["upd"][rows[0, 2]:rows[-1, 3]]
            np.testing.assert_array_equal(upd[:, 0], li[real])
            np.testing.assert_array_equal(upd[:, 1], ui[real])
            np.testing.assert_array_equal(upd[:, 3], dl[real])
            np.testing.assert_array_equal(
                upd[:, 2], [diag_of[int(i)] for i in upd[:, 0]])
            # one work item per row (no row of these plans exceeds a block)
            assert i1 - i0 == len(rows) and col_len.max() <= 1024
        assert len(h["upd"]) == run.n_updates


@pytest.mark.parametrize("name", ["sparse", "tail", "flat", "grid64"])
def test_invariants_hold_on_plans(plans, name):
    _, tplan = _get(plans, name)
    for run, _ in _runs(tplan)[1]:
        h = run.host
        check_run_invariants(h["levels"], h["rows"], h["upd"], h["norm"])


def test_merged_dependent_levels_are_refused(plans):
    """Two consecutive K1 levels depend on each other: a plan that puts them
    in one level is refused by `_build_run_layout` and by the factorizer."""
    _, tplan = _get(plans, "tail")
    segs = tplan.segments
    k = next(i for i, (a, b) in enumerate(zip(segs, segs[1:]))
             if "flat" not in (a.mode, b.mode) and a.n_upd and b.n_upd)
    a, b = segs[k], segs[k + 1]
    merged = dataclasses.replace(
        a, cols=np.concatenate([a.cols, b.cols]),
        norm_slice=slice(a.norm_slice.start, b.norm_slice.stop),
        upd_slice=slice(a.upd_slice.start, b.upd_slice.stop))
    _build_run_layout(tplan, [a, b], "cpu")          # as planned: fine
    with pytest.raises(ValueError, match="I[123]"):
        _build_run_layout(tplan, [merged], "cpu")
    bad = dataclasses.replace(tplan, segments=segs[:k] + [merged] + segs[k + 2:])
    with pytest.raises(ValueError, match="I[123]"):
        TorchFactorizer(bad, device="cpu")


def _mutated(which):
    """A valid synthetic run, then one change that breaks invariant
    ``which``; returns the host arrays."""
    run, _ = random_level_run(np.random.default_rng(4),
                              [(6, 5, 9), (5, 4, 7)], torch.float64, "cpu")
    h = {k: v.copy() for k, v in run.host.items()}
    if which == "I1":     # the second row of level 0 overlaps the first
        h["rows"][1, 0] = h["rows"][0, 0] + 1
    elif which == "I2":   # level 0 reads a slot it writes
        h["upd"][0, 1] = h["rows"][2, 0] + h["upd"][2 * 5, 3]
    elif which == "I3":   # level 1 reads an L entry level 0 normalizes
        first = h["levels"][1, 2]
        h["upd"][h["rows"][first, 2], 1] = h["norm"][0, 0]
    else:                 # level 1 normalizes an L entry level 0 does
        h["norm"][h["levels"][1, 0], 0] = h["norm"][0, 0]
    return h


@pytest.mark.parametrize("which", ["I1", "I2", "I3", "I3-twice"])
def test_each_invariant_is_checked(which):
    h = _mutated(which)
    which = which.split("-")[0]
    with pytest.raises(ValueError, match=which):
        check_run_invariants(h["levels"], h["rows"], h["upd"], h["norm"])
    with pytest.raises(ValueError, match=which):
        LevelRun(h["levels"], h["rows"], h["upd"], h["norm"],
                 int(h["rows"][:, :2].sum(1).max()) + 1, "cpu")


def test_layout_structure_and_int32_limits_are_checked():
    run, _ = random_level_run(np.random.default_rng(5), [(4, 3, 6)],
                              torch.float64, "cpu")
    h = run.host
    n_vals = run.n_vals
    bad_pos = h["upd"].copy()
    bad_pos[0, 3] = h["rows"][0, 1]                   # past its segment
    bad_rows = h["rows"].copy()
    bad_rows[0, 3] += 1                               # ranges overlap
    big = h["upd"].copy()
    big[0, 0] = 2 ** 31                               # not an int32
    for args in ((h["levels"], h["rows"], bad_pos, h["norm"], n_vals),
                 (h["levels"], bad_rows, h["upd"], h["norm"], n_vals),
                 (h["levels"], h["rows"], big, h["norm"], n_vals),
                 (h["levels"], h["rows"], h["upd"], h["norm"], n_vals - 1),
                 (h["levels"], h["rows"], h["upd"], h["norm"], 2 ** 31)):
        with pytest.raises(ValueError):
            LevelRun(*args, "cpu")


@pytest.fixture(scope="module")
def ac_plan():
    g = repro_torch.GLU(tsparse.ac_jacobian(300, avg_degree=4.0, seed=0),
                        dtype=torch.complex128, device="cpu", plan_cache=None)
    g.factorize()            # sets the plan-ordered, scaled A values
    return g.plan, g._a_vals


def _before_first_run(tf, a_vals):
    """The value array just before the factorizer's first run step."""
    vals = torch.zeros(tf.nnz + 1, dtype=tf.dtype)
    vals[tf._a_scatter] = torch.as_tensor(a_vals).to(tf.dtype)
    for g in tf._groups[: tf.step_kinds.index("run")]:
        tf._step[g.kind](vals, *g.arrays)
    return vals


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128, torch.complex64])
def test_plain_run_equals_per_level_route(plans, ac_plan, dtype):
    """The plain run, on the values the factorizer gives it, equals bit for
    bit the per-level route it replaces (normalize, gather, the plain
    accumulation of the TPU kernel's function, write back, one level at a
    time): real values on the dense-tail fixture, complex ones on the AC
    matrix."""
    if dtype.is_complex:
        tplan, a_vals = ac_plan
        step = level_update_planar_body
    else:
        tplan = _get(plans, "tail")[1]
        a_vals = np.random.default_rng(2).uniform(0.5, 1.5,
                                                  tplan.a_scatter.size)
        a_vals[np.isin(tplan.a_scatter, tplan.diag_idx)] += 20.0
        step = level_update_body
    tf = TorchFactorizer(tplan, dtype=dtype, device="cpu")
    run = next(g.arrays[0] for g in tf._groups if g.kind == "run")
    segs = [s for s, k in zip(tplan.segments, tf.kinds) if k == "pallas"]
    before = _before_first_run(tf, a_vals)
    got = level_run_ref(before.clone(), run)
    want = before.clone()
    for seg in segs[: run.n_levels]:
        arrays = [torch.from_numpy(np.asarray(a)).long()
                  for a in _build_pallas_layout(tplan, seg, tf.nnz)]
        arrays[4] = arrays[4].int()
        step(want, *arrays)
    assert not torch.equal(got, before)
    assert torch.equal(got[: tf.nnz], want[: tf.nnz])
    # the wrapper runs the plain version for a CPU tensor and counts nothing
    n = level_run.launches
    assert torch.equal(level_run(before.clone(), run), got)
    assert level_run.launches == n


@pytest.mark.parametrize("name", ["sparse", "tail", "flat"])
def test_factorizer_with_run_matches_reference(plans, name):
    jplan, tplan = _get(plans, name)
    rng = np.random.default_rng(3)
    vals0 = rng.uniform(0.5, 1.5, size=jplan.nnz)
    vals0[jplan.diag_idx] += 20.0
    jf = jcore.JaxFactorizer(jplan, dtype=jnp.float64, use_pallas=True,
                             interpret=True)
    tf = TorchFactorizer(tplan, device="cpu")
    assert "run" in tf.step_kinds
    want = np.asarray(jf.factorize_filled(jnp.asarray(vals0)))
    got = tf.factorize_filled(vals0).numpy()
    np.testing.assert_allclose(got, want, rtol=FACT_TOL, atol=FACT_TOL)
    assert tf.last_n_dispatches == 1 + len(tf.step_kinds) < 1 + len(tf.kinds)


def test_complex_glu_with_run_matches_reference():
    A = jsparse.ac_jacobian(300, avg_degree=4.0, seed=0)
    gj = jcore.GLU(A, dtype=jnp.complex128, use_pallas=True, plan_cache=None)
    gt = repro_torch.GLU(tsparse.ac_jacobian(300, avg_degree=4.0, seed=0),
                         dtype=torch.complex128, device="cpu", plan_cache=None)
    rng = np.random.default_rng(1)
    b = rng.normal(size=A.n) + 1j * rng.normal(size=A.n)
    xj = gj.factorize().solve(b)
    xt = gt.factorize().solve(b)
    assert gt._factorizer.step_kinds.count("run") >= 1
    np.testing.assert_allclose(gt.factorized_values().numpy(),
                               np.asarray(gj.factorized_values()),
                               rtol=FACT_TOL, atol=FACT_TOL)
    np.testing.assert_allclose(xt, xj, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    assert gt.solve_info["n_dispatches"] == 1 + gt._factorizer.n_groups


def test_level_run_refuses_other_devices():
    run, vals = random_level_run(np.random.default_rng(6), [(3, 4, 5)],
                                 torch.float64, "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        level_run(torch.empty_like(vals, device="meta"), run)
