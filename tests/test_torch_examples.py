"""The port's examples (``examples/torch_*.py``), each the reference
example's program on ``repro_torch``, run in-process on the CPU at
reduced sizes through their ``main(argv)``.

The circuit examples are held against the reference function on the same
inputs to 1e-9 (PERF.md §2): ``GLU`` solutions, ``transient`` and
``transient_sweep`` voltages with equal Newton counts, and ``ac_sweep``
voltages in both complex layouts (the reference's default ``ac_sweep`` is
its native route).  The LM examples are held to their invariants: the
generated shapes and token range, and a training loss that decreases.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

import repro.circuit as jcirc
import repro.core as jcore
import repro.sparse as jsparse

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9


def _example(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference():
    out = _example("quickstart").main(["--n", "300", "--device", "cpu"])
    A = jsparse.circuit_jacobian(300, avg_degree=4.0, seed=0)
    b = np.random.default_rng(0).normal(size=A.n)
    g = jcore.GLU(A, dtype=jnp.float64)
    want = [np.asarray(g.factorize().solve(b))]
    for it in range(3):
        g.factorize(np.asarray(A.data) * (1.0 + 0.1 * it))
        want.append(np.asarray(g.solve(b)))
    assert out["solutions"].shape == (4, 300)
    np.testing.assert_allclose(out["solutions"], np.stack(want), rtol=TOL,
                               atol=TOL)
    assert max(out["residuals"]) < 1e-9
    assert out["nnz_filled"] == g.nnz_filled


def test_circuit_transient_matches_reference():
    args = dict(t_end=0.02, dt=0.002)
    res = _example("circuit_transient").main(
        ["--nx", "4", "--ny", "4", "--t-end", "0.02", "--dt", "0.002",
         "--device", "cpu"])
    ref = jcirc.transient(jcirc.rc_grid_circuit(4, 4, with_diodes=True,
                                                seed=0), **args)
    np.testing.assert_allclose(res.voltages, ref.voltages, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(res.newton_iters, ref.newton_iters)
    assert res.n_factorizations == ref.n_factorizations


def test_transient_sweep_matches_reference():
    res = _example("transient_sweep").main(
        ["--nx", "4", "--ny", "4", "--t-end", "0.01", "--dt", "0.002",
         "--corners", "3", "--device", "cpu"])
    ref = jcirc.transient_sweep(
        jcirc.rc_grid_circuit(4, 4, with_diodes=True, seed=0), t_end=0.01,
        dt=0.002, scales=np.linspace(0.8, 1.2, 3))
    assert res.voltages.shape == ref.voltages.shape
    np.testing.assert_allclose(res.voltages, ref.voltages, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(res.newton_iters, ref.newton_iters)


@pytest.mark.parametrize("layout", ["auto", "native"])
def test_ac_sweep_matches_reference(layout):
    res = _example("ac_sweep").main(["--nx", "4", "--ny", "4", "--points",
                                     "9", "--layout", layout,
                                     "--device", "cpu"])
    ckt = jcirc.rc_grid_circuit(4, 4, with_diodes=True, seed=0)
    ckt.add_ac_current_source(1, 0, 1.0)
    ref = jcirc.ac_sweep(ckt, np.logspace(0, 5, 9))
    assert ref.voltages.shape == res.voltages.shape == (9, 16)
    np.testing.assert_allclose(res.voltages, ref.voltages, rtol=TOL, atol=TOL)
    assert res.op_newton_iters == ref.op_newton_iters


def test_serve_lm_shapes():
    out = _example("serve_lm").main(["--layers", "1", "--d-model", "64",
                                     "--max-new", "4", "--device", "cpu"])
    cfg = out["cfg"]
    assert cfg.num_layers == 1 and cfg.d_model == 64
    batch = out["batch"]
    assert batch.shape == (4, 4) and batch.dtype == np.int32
    assert ((batch >= 0) & (batch < cfg.padded_vocab)).all()
    assert sorted(out["requests"]) == [0, 1, 2, 3]
    for toks in out["requests"].values():
        assert toks.shape == (8,)
        assert ((toks >= 0) & (toks < cfg.padded_vocab)).all()


def test_train_lm_loss_decreases(tmp_path):
    mod = _example("train_lm")
    assert mod.BUILD == ROOT / "build"
    metrics = tmp_path / "metrics.json"
    hist = mod.main(["--device", "cpu", "--steps", "8", "--layers", "2",
                     "--d-model", "64", "--d-ff", "128", "--vocab", "512",
                     "--seq", "32", "--log-every", "1",
                     "--ckpt-dir", str(tmp_path / "ckpt"),
                     "--metrics-out", str(metrics)])
    assert [h["step"] for h in hist] == list(range(8))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert json.loads(metrics.read_text()) == hist
    assert (tmp_path / "ckpt" / "step_8").exists()
    # a second run with the same steps resumes at the end and takes none
    again = mod.main(["--device", "cpu", "--steps", "8", "--layers", "2",
                      "--d-model", "64", "--d-ff", "128", "--vocab", "512",
                      "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt"),
                      "--metrics-out", str(tmp_path / "again.json")])
    assert again == []
