"""PyTorch port, scenario-sharded sweeps on the CPU.

``repro_torch.distributed`` (the mesh, the sharding's descriptor and
padding, ``psum_exact``) and the sharded batched engine: ``GLU(mesh=)``,
``transient_sweep(mesh=)`` and ``ac_sweep(mesh=)`` on emulated meshes of
the CPU device repeated 2, 4 and 8 times, against the port's unsharded
batch and the JAX package's batched ``GLU``.  The matrix and the five
modes are those of the JAX package's own sharded test
(tests/test_sharded_sweep.py): ``circuit_jacobian(120, avg_degree=4.0,
seed=7)``, B = 16, float64, float64 with ``static_pivot=1e-12,
refine=2``, ``dense_tail=False``, complex128 (auto layout) and complex128
planar.

Tolerances: a sharded batch equals the unsharded one bit for bit (rows
never interact); against the reference, factors 1e-10 and solutions 1e-9
(the reference's own, tests/test_batched.py).  One exception, on the CPU
only: a complex product's last bit depends on where it sits in PyTorch's
vectorized loop (its body or its FMA-contracted scalar tail), and a shard
of 2 rows puts other entries in the tail than the batch of 16, so complex
solutions are held to 1e-12 relative there (their factors stay bit for
bit); tests/test_torch_cuda.py holds them bit for bit on the card.
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
from repro_torch.distributed import (
    SweepMesh,
    make_scenario_sharding,
    make_sweep_mesh,
    psum_exact,
)

B = 16
MATRIX = dict(n=120, avg_degree=4.0, seed=7)
FACT_TOL, SOLVE_TOL = 1e-10, 1e-9
CPU_COMPLEX_RTOL = 1e-12
SHARDS = (2, 4, 8)
# name -> (port GLU options, reference GLU options, complex values)
MODES = {
    "f64": (dict(dtype=torch.float64), dict(dtype=jnp.float64), False),
    "f64_robust": (dict(dtype=torch.float64, static_pivot=1e-12, refine=2),
                   dict(dtype=jnp.float64, static_pivot=1e-12, refine=2),
                   False),
    "f64_sparse_only": (dict(dtype=torch.float64, dense_tail=False),
                        dict(dtype=jnp.float64, dense_tail=False), False),
    "c128_auto": (dict(dtype=torch.complex128),
                  dict(dtype=jnp.complex128, layout="planar"), True),
    "c128_planar": (dict(dtype=torch.complex128, layout="planar"),
                    dict(dtype=jnp.complex128, layout="planar"), True),
}


def cpu_mesh(k: int) -> SweepMesh:
    return make_sweep_mesh(devices=["cpu"] * k)


@pytest.fixture(scope="module")
def data():
    A = tsparse.circuit_jacobian(**MATRIX)
    rng = np.random.default_rng(0)
    vals = np.asarray(A.data)[None] * (
        1.0 + 0.1 * rng.uniform(-1, 1, size=(B, A.nnz)))
    rhs = rng.normal(size=(B, A.n))
    cvals = vals * np.exp(1j * rng.uniform(-0.3, 0.3, size=vals.shape))
    crhs = rhs + 1j * rng.normal(size=rhs.shape)
    return dict(A=A, Aj=jsparse.circuit_jacobian(**MATRIX),
                real=(vals, rhs), cplx=(cvals, crhs))


@pytest.fixture(scope="module")
def unsharded(data):
    """mode -> the port's unsharded batch (solutions, factors, solve_info)
    and the reference's batched GLU (solutions, factors), each run once."""
    out = {}
    for name, (kw, jkw, cplx) in MODES.items():
        v, b = data["cplx" if cplx else "real"]
        g = repro_torch.GLU(data["A"], device="cpu", **kw)
        x = g.refactorize_solve(v, b)
        gj = jcore.GLU(data["Aj"], **jkw)
        xj = np.asarray(gj.refactorize_solve(v, b))
        out[name] = dict(x=x, f=g.factorized_values_batched(),
                         info=g.solve_info, xj=xj,
                         fj=np.asarray(gj.factorized_values_batched()))
    return out


# -- the mesh and the sharding ---------------------------------------------

def test_no_mesh_means_no_sharding():
    assert make_scenario_sharding(None) is None


def test_single_device_mesh_stays_unsharded():
    assert make_scenario_sharding(cpu_mesh(1)) is None


def test_make_sweep_mesh_rejects_oversubscription():
    with pytest.raises(ValueError):
        make_sweep_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        make_sweep_mesh(0, devices=["cpu"])


def test_make_sweep_mesh_defaults_to_the_cards():
    """Without ``devices`` the mesh is every CUDA card, and without a card
    it raises: nothing shards onto the CPU in silence."""
    if torch.cuda.is_available():
        mesh = make_sweep_mesh()
        assert len(mesh.devices) == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_sweep_mesh()


def test_sharding_descriptor_and_padding():
    s4 = make_scenario_sharding(cpu_mesh(4))
    s8 = make_scenario_sharding(cpu_mesh(8))
    assert s4 is not None and s4.n_shards == 4 and s8.n_shards == 8
    assert s4.pad(7) == 8 and s4.pad(8) == 8 and s4.pad(1) == 4
    assert s8.descriptor != s4.descriptor
    assert hash(s4.descriptor) == hash(make_scenario_sharding(
        cpu_mesh(4)).descriptor)
    assert s4.spec == "PartitionSpec('data',)"
    blocks = s4.split(np.arange(8))
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        s4.split(np.arange(6))


def test_psum_exact_sums_every_shard():
    parts = [torch.tensor(i, dtype=torch.int32) for i in range(8)]
    total = psum_exact(parts)
    assert total.dtype == torch.int64 and int(total) == 28
    with pytest.raises(TypeError):
        psum_exact([torch.tensor(1.0)])


# -- the five modes ------------------------------------------------------------

@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_refactorize_solve_equals_unsharded(data, unsharded, mode, k):
    kw, _, cplx = MODES[mode]
    v, b = data["cplx" if cplx else "real"]
    ref = unsharded[mode]
    g = repro_torch.GLU(data["A"], device="cpu", mesh=cpu_mesh(k), **kw)
    assert g.n_devices == k
    x = g.refactorize_solve(v, b)
    f = g.factorized_values_batched()
    assert torch.equal(f, ref["f"])
    if cplx:
        np.testing.assert_allclose(x, ref["x"], rtol=CPU_COMPLEX_RTOL, atol=0)
    else:
        assert np.array_equal(x, ref["x"])
    np.testing.assert_allclose(x, ref["xj"], rtol=SOLVE_TOL, atol=SOLVE_TOL)
    np.testing.assert_allclose(f.numpy(), ref["fj"], rtol=FACT_TOL,
                               atol=FACT_TOL)
    info, uinfo = g.solve_info, ref["info"]
    assert info["n_devices"] == k
    assert info["batch_spec"] == "PartitionSpec('data',)"
    assert uinfo["n_devices"] == 1 and uinfo["batch_spec"] is None
    # a shard issues the unsharded batch's dispatches
    assert info["n_dispatches"] == uinfo["n_dispatches"]
    assert info["solve_dispatches"] == uinfo["solve_dispatches"]
    for key in ("pivot_growth", "min_diag", "refine_iters"):
        np.testing.assert_array_equal(info[key], uinfo[key])
    if "static_pivot" in kw:
        assert np.asarray(info["n_perturbed"]).shape == (B,)
        assert info["n_perturbed_global"] == int(np.sum(info["n_perturbed"]))
    else:
        assert info["n_perturbed_global"] is None


@pytest.mark.parametrize("k", SHARDS)
def test_factorize_then_solve_batched_sharded(data, unsharded, k):
    """``factorize_batched`` then ``solve_batched`` (unrefined and
    refined) on a sharded batch: the unsharded rows bit for bit."""
    v, b = data["real"]
    g = repro_torch.GLU(data["A"], device="cpu", mesh=cpu_mesh(k))
    g0 = repro_torch.GLU(data["A"], device="cpu")
    g.factorize_batched(v)
    g0.factorize_batched(v)
    assert torch.equal(g.factorized_values_batched(),
                       g0.factorized_values_batched())
    for refine in (0, 2):
        assert np.array_equal(g.solve_batched(b, refine=refine),
                              g0.solve_batched(b, refine=refine))
        for key in ("refine_iters", "host_syncs", "solve_dispatches"):
            np.testing.assert_array_equal(g.solve_info[key],
                                          g0.solve_info[key])
    # a second call replays the same shards' buffers
    assert np.array_equal(g.refactorize_solve(v[::-1], b),
                          g0.refactorize_solve(v[::-1], b))


def test_pruned_sharded_solve(data):
    """``rhs_pattern`` runs per shard: the unsharded pruned rows."""
    v, b = data["real"]
    pat = [3, 40, 97]
    bs = np.zeros_like(b)
    bs[:, pat] = b[:, pat]
    g = repro_torch.GLU(data["A"], device="cpu", mesh=cpu_mesh(4))
    g0 = repro_torch.GLU(data["A"], device="cpu")
    g.factorize_batched(v)
    g0.factorize_batched(v)
    assert np.array_equal(g.solve_batched(bs, rhs_pattern=pat),
                          g0.solve_batched(bs, rhs_pattern=pat))


def test_padding_b7_on_4_shards(data):
    """B = 7 on 4 shards pads to 8 with a copy of the last scenario; the
    results and every per-matrix diagnostic are (7, ...), and
    ``n_perturbed_global`` counts the pad row's bumps, as the reference's
    psum over the padded batch does."""
    v, b = data["real"]
    kw = dict(dtype=torch.float64, static_pivot=0.6, refine=2)
    v7, b7 = v[:7], b[:7]
    g0 = repro_torch.GLU(data["A"], device="cpu", **kw)
    ref = g0.refactorize_solve(v7, b7)
    g = repro_torch.GLU(data["A"], device="cpu", mesh=cpu_mesh(4), **kw)
    got = g.refactorize_solve(v7, b7)
    assert got.shape == (7, data["A"].n) and np.array_equal(got, ref)
    assert g.factorized_values_batched().shape[0] == 7
    info, uinfo = g.solve_info, g0.solve_info
    assert info["n_devices"] == 4
    for key in ("pivot_growth", "min_diag", "n_perturbed", "refine_iters",
                "backward_error", "converged"):
        assert np.asarray(info[key]).shape == (7,), key
        np.testing.assert_array_equal(info[key], uinfo[key])
    n_pert = info["n_perturbed"]
    assert n_pert.sum() > 0
    assert info["n_perturbed_global"] == int(n_pert.sum() + n_pert[-1])
    # the reference's per-matrix counts on the same batch
    gj = jcore.GLU(data["Aj"], dtype=jnp.float64, static_pivot=0.6, refine=2)
    gj.refactorize_solve(v7, b7)
    np.testing.assert_array_equal(n_pert, gj.solve_info["n_perturbed"])


def test_single_pair_and_unbatched_calls_stay_unsharded(data):
    v, b = data["real"]
    g = repro_torch.GLU(data["A"], device="cpu", mesh=cpu_mesh(4))
    g0 = repro_torch.GLU(data["A"], device="cpu")
    assert np.array_equal(g.refactorize_solve(v[0], b[0]),
                          g0.refactorize_solve(v[0], b[0]))
    assert g.solve_info["n_devices"] == 1
    assert g.solve_info["batch_spec"] is None
    assert np.array_equal(g.factorize(v[1]).solve(b[1]),
                          g0.factorize(v[1]).solve(b[1]))
    assert g.solve_info["n_devices"] == 1


def test_one_device_mesh_is_noop(data):
    v, b = data["real"]
    g = repro_torch.GLU(data["A"], device="cpu", mesh=cpu_mesh(1))
    assert g.n_devices == 1
    x = g.refactorize_solve(v[:3], b[:3])
    assert np.array_equal(x, repro_torch.GLU(data["A"], device="cpu")
                          .refactorize_solve(v[:3], b[:3]))
    assert g.solve_info["n_devices"] == 1
    assert g.solve_info["batch_spec"] is None


def test_mesh_device_must_be_the_glus(data):
    with pytest.raises(ValueError, match="first device"):
        repro_torch.GLU(data["A"], device="cuda:3", mesh=cpu_mesh(2))


def test_shards_own_their_schedules(data):
    """Each shard's factorizer and solver cache their schedules under a
    key of their own: no key is shared with the unsharded executors."""
    from repro_torch.core.executor import ExecutableCache

    cache = ExecutableCache()
    v, b = data["real"]
    g = repro_torch.GLU(data["A"], device="cpu", mesh=cpu_mesh(2),
                        executable_cache=cache)
    before = set(cache.keys())
    g.refactorize_solve(v[:4], b[:4])
    new = set(cache.keys()) - before
    assert len([k for k in new if k[0] == "factorize"]) == 2
    assert len([k for k in new if k[0] == "trisolve"]) == 2
    assert all(k[-1] is not None for k in new)


# -- the sweeps ------------------------------------------------------------

GRID = dict(nx=4, ny=4, with_diodes=True, seed=1)
SCALES = [0.8, 0.9, 1.0, 1.1, 1.2]


@pytest.fixture(scope="module")
def sweep_unsharded():
    ckt = tcirc.rc_grid_circuit(**GRID)
    kw = dict(t_end=0.02, dt=0.005, scales=SCALES, device="cpu")
    return (tcirc.transient_sweep(ckt, **kw),
            jcirc.transient_sweep(jcirc.rc_grid_circuit(**GRID), t_end=0.02,
                                  dt=0.005, scales=SCALES))


@pytest.mark.parametrize("k", SHARDS)
def test_transient_sweep_sharded(sweep_unsharded, k):
    want, ref = sweep_unsharded
    got = tcirc.transient_sweep(tcirc.rc_grid_circuit(**GRID), t_end=0.02,
                                dt=0.005, scales=SCALES, device="cpu",
                                mesh=cpu_mesh(k))
    assert got.n_devices == k and want.n_devices == 1
    assert np.array_equal(got.voltages, want.voltages)
    np.testing.assert_array_equal(got.newton_iters, want.newton_iters)
    assert got.n_batched_factorizations == want.n_batched_factorizations
    assert got.ladder_counts == want.ladder_counts
    np.testing.assert_allclose(got.voltages, ref.voltages, rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)


def _ac_grid(pkg):
    ckt = pkg.rc_grid_circuit(5, 5, with_diodes=False, seed=2)
    ckt.add_ac_current_source(3, 0, 1.0)
    return ckt


AC_FREQS = np.logspace(0, 5, 8)


@pytest.fixture(scope="module")
def ac_unsharded():
    return (tcirc.ac_sweep(_ac_grid(tcirc), AC_FREQS, device="cpu"),
            jcirc.ac_sweep(_ac_grid(jcirc), AC_FREQS))


@pytest.mark.parametrize("k", SHARDS)
def test_ac_sweep_sharded(ac_unsharded, k):
    want, ref = ac_unsharded
    got = tcirc.ac_sweep(_ac_grid(tcirc), AC_FREQS, device="cpu",
                         mesh=cpu_mesh(k))
    assert got.n_devices == k and want.n_devices == 1
    # complex solutions on the CPU: see the module docstring
    np.testing.assert_allclose(got.voltages, want.voltages,
                               rtol=CPU_COMPLEX_RTOL, atol=0)
    np.testing.assert_array_equal(got.op_point, want.op_point)
    assert got.n_batched_factorizations == want.n_batched_factorizations
    assert got.max_backward_error <= 1e-10
    np.testing.assert_allclose(got.voltages, ref.voltages, rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)
