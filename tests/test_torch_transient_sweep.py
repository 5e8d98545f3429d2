"""PyTorch port, the batched transient sweep on the CPU: B perturbed copies
of one circuit stepped in lockstep on one plan (``transient_sweep``,
``perturbed_copies``) against the JAX package's on the same circuits.
Voltages agree to 1e-9 (the same plans, factors to rounding); Newton
iterations, batched factorizations and ladder counts are equal.  The copy
at scale 1.0 is the circuit itself: it is held against the port's
single-matrix ``transient`` to 1e-9.
"""
import numpy as np
import pytest

import repro.circuit as jcirc
import repro_torch.circuit as tcirc
from repro.circuit.simulate import transient_sweep as jax_transient_sweep

TOL = 1e-9
GRID = dict(nx=4, ny=4, with_diodes=True, seed=1)
SCALES = [0.9, 1.0, 1.1]

# (transient_sweep keyword arguments): the issue's case, refinement with
# static pivoting, and the single-rebuild escalation
CASES = {
    "default": dict(t_end=0.02, dt=0.005),
    "refined-pivot": dict(t_end=0.01, dt=0.005, refine=2, static_pivot=1e-10),
    "rescale": dict(t_end=0.01, dt=0.005, refine=1, escalation="rescale"),
}


@pytest.fixture(scope="module")
def sweeps():
    """case -> (reference result, port result), each run once."""
    out = {}
    for name, kw in CASES.items():
        want = jax_transient_sweep(jcirc.rc_grid_circuit(**GRID),
                                   scales=SCALES, **kw)
        got = tcirc.transient_sweep(tcirc.rc_grid_circuit(**GRID),
                                    scales=SCALES, device="cpu", **kw)
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_matches_reference(sweeps, name):
    want, got = sweeps[name]
    assert got.voltages.shape == want.voltages.shape == (
        len(SCALES), len(got.times), 16)
    np.testing.assert_allclose(got.voltages, want.voltages, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.newton_iters, want.newton_iters)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.scales, want.scales)
    assert got.n_batched_factorizations == want.n_batched_factorizations \
        == got.newton_iters.sum()
    assert got.ladder_counts == want.ladder_counts
    assert got.n_rescalings == want.n_rescalings
    assert got.n_full_rebuilds == want.n_full_rebuilds
    assert got.max_residual < 1e-8 and np.isfinite(got.voltages).all()


def test_scale_one_copy_equals_transient(sweeps):
    """The copy at scale 1.0 against the port's ``transient`` of the
    circuit alone (a converged copy is frozen while the others iterate, so
    the two agree to the Newton tolerance's rounding, not the bit)."""
    _, got = sweeps["default"]
    single = tcirc.transient(tcirc.rc_grid_circuit(**GRID), device="cpu",
                             **CASES["default"])
    np.testing.assert_allclose(got.voltages[SCALES.index(1.0)],
                               single.voltages, rtol=TOL, atol=TOL)


def test_perturbed_copies_match_reference():
    jc = jcirc.perturbed_copies(jcirc.rc_grid_circuit(**GRID), SCALES)
    tc = tcirc.perturbed_copies(tcirc.rc_grid_circuit(**GRID), SCALES)
    assert len(tc) == len(jc) == len(SCALES)
    for a, b in zip(jc, tc):
        assert a.n_nodes == b.n_nodes
        assert a.resistors == b.resistors and a.capacitors == b.capacitors
        assert a.diodes == b.diodes
        assert a.pattern().indices.tobytes() == b.pattern().indices.tobytes()
        v = np.linspace(0.0, 0.5, b.n)
        for x, y in zip(a.assemble(v, v * 0.9, 0.005, 0.01),
                        b.assemble(v, v * 0.9, 0.005, 0.01)):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_sweep_mesh_raises():
    """A ``mesh`` that is no ``SweepMesh`` is refused (sharded sweeps:
    tests/test_torch_sharded_sweep.py)."""
    with pytest.raises(TypeError, match="mesh"):
        tcirc.transient_sweep(tcirc.rc_grid_circuit(**GRID), t_end=0.005,
                              dt=0.005, scales=SCALES, device="cpu",
                              mesh=object())
