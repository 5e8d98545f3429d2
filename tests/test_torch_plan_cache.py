"""PyTorch port on the CPU: the on-disk ``PlanCache``, the left-looking
baseline ``leftlooking_numpy`` and the ``repro_torch.launch.simulate`` CLI.

* ``PlanCache(directory=)`` writes ``<key>.plan.npz`` (plain arrays) and a
  second cache on the directory serves a disk hit with the same plan
  digest and arrays; a corrupt, stale or foreign file is a miss, and the
  JAX package's pickled ``<key>.plan`` in a shared directory is never
  opened (nothing is unpickled: ``pickle.load`` is made to fail).
* ``leftlooking_numpy`` (paper Algorithm 1) within 1e-12 of the
  reference's (the same loop, so equal to rounding) and of the port's
  right-looking ``factorize_numpy`` (Algorithm 2, the same LU).
* The CLI's ``main`` on a 4 x 4 grid with ``--device cpu`` against the
  reference's ``main``: voltages within 1e-9, equal Newton and
  factorization counts, and its two lines.
"""
import pickle

import numpy as np
import pytest

import repro.core.factorize as jfact
import repro.core.planner as jplanner
import repro.launch.simulate as jsim
import repro.sparse as jsparse
import repro_torch.launch.simulate as tsim
import repro_torch.sparse as tsparse
from repro.core.symbolic import symbolic_fillin_gp as jax_fillin
from repro_torch.convert import plan_to_arrays
from repro_torch.core import PlanCache, plan_factorization
from repro_torch.core.factorize import factorize_numpy, leftlooking_numpy
from repro_torch.core.symbolic import symbolic_fillin_gp

MATRIX = dict(n=250, avg_degree=4.0, seed=11)


@pytest.fixture
def no_unpickling(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the plan cache unpickled a file")

    monkeypatch.setattr(pickle, "load", boom)
    monkeypatch.setattr(pickle, "loads", boom)


def _plan_file(directory):
    files = [p for p in directory.iterdir() if p.name.endswith(".plan.npz")]
    assert len(files) == 1, files
    return files[0]


def test_disk_round_trip(tmp_path, no_unpickling):
    A = tsparse.circuit_jacobian(**MATRIX)
    c1 = PlanCache(directory=tmp_path)
    p1, _, hit1 = plan_factorization(A, cache=c1)
    assert not hit1 and c1.stats.builds == 1
    path = _plan_file(tmp_path)
    assert path.name == f"{p1.key}.plan.npz"
    assert not list(tmp_path.glob("*.tmp"))
    c2 = PlanCache(directory=tmp_path)
    p2, _, hit2 = plan_factorization(A, cache=c2)
    assert hit2 and c2.stats.disk_hits == 1 and c2.stats.builds == 0
    assert p2.fplan.digest == p1.fplan.digest and p2.key == p1.key
    a1, a2 = plan_to_arrays(p1), plan_to_arrays(p2)
    assert a1.keys() == a2.keys()
    for k in a1:
        assert np.array_equal(np.asarray(a1[k]), np.asarray(a2[k])), k
    # a second get is a memory hit
    assert c2.get(p1.key) is p2 and c2.stats.disk_hits == 1
    # evictions drop the memory copy only
    c2.clear()
    assert c2.get(p1.key) is not None and c2.stats.disk_hits == 2


def test_disk_hit_solves_like_a_fresh_plan(tmp_path):
    import repro_torch

    A = tsparse.circuit_jacobian(**MATRIX)
    b = np.random.default_rng(1).normal(size=A.n)
    x1 = repro_torch.GLU(A, device="cpu",
                         plan_cache=PlanCache(directory=tmp_path)).solve(b)
    g2 = repro_torch.GLU(A, device="cpu",
                         plan_cache=PlanCache(directory=tmp_path))
    assert g2.plan_from_cache
    assert np.array_equal(g2.solve(b), x1)


@pytest.mark.parametrize("damage", ["corrupt", "stale", "other_key",
                                    "pickled"])
def test_damaged_file_is_a_miss(tmp_path, no_unpickling, damage):
    A = tsparse.grid_laplacian(6, 6)
    plan, _, _ = plan_factorization(A, cache=PlanCache(directory=tmp_path))
    path = _plan_file(tmp_path)
    if damage == "corrupt":
        path.write_bytes(b"not a zip archive")
    else:
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
        if damage == "stale":
            d["format_version"] = d["format_version"] - 1
        elif damage == "other_key":
            d["key"] = np.asarray("0" * 64)
        else:
            d["levels"] = np.asarray([object()], dtype=object)
        with open(path, "wb") as f:
            np.savez(f, **d)
    c = PlanCache(directory=tmp_path)
    assert c.get(plan.key) is None
    assert c.stats.misses == 1 and c.stats.disk_hits == 0
    # the miss rebuilds and rewrites a good file
    _, _, hit = plan_factorization(A, cache=c)
    assert not hit
    assert PlanCache(directory=tmp_path).get(plan.key) is not None


def test_reference_pickles_are_never_opened(tmp_path, no_unpickling):
    """A directory shared with the JAX package: its ``<key>.plan`` pickle
    (same key) is not the port's file, and the port builds its own."""
    Aj = jsparse.circuit_jacobian(**MATRIX)
    At = tsparse.circuit_jacobian(**MATRIX)
    jplanner.plan_factorization(Aj, cache=jplanner.PlanCache(
        directory=str(tmp_path)))
    assert [p.suffix for p in tmp_path.iterdir()] == [".plan"]
    c = PlanCache(directory=tmp_path)
    plan, _, hit = plan_factorization(At, cache=c)
    assert not hit and c.stats.disk_hits == 0 and c.stats.builds == 1
    assert (tmp_path / f"{plan.key}.plan").exists()
    assert (tmp_path / f"{plan.key}.plan.npz").exists()


def test_capacity_and_stats(tmp_path):
    with pytest.raises(ValueError):
        PlanCache(capacity=0, directory=tmp_path)
    c = PlanCache(capacity=1, directory=tmp_path / "sub")
    assert (tmp_path / "sub").is_dir()
    plan_factorization(tsparse.grid_laplacian(5, 5), cache=c)
    plan_factorization(tsparse.grid_laplacian(6, 6), cache=c)
    assert len(c) == 1 and c.stats.evictions == 1
    assert set(c.stats.snapshot()) == {"hits", "misses", "evictions",
                                       "builds", "disk_hits"}


# -- leftlooking_numpy ---------------------------------------------------------

@pytest.fixture(scope="module")
def filled():
    A = tsparse.circuit_jacobian(**MATRIX)
    As = symbolic_fillin_gp(A)
    return As, As.filled_csc(A).data


def test_leftlooking_matches_reference(filled):
    As, vals0 = filled
    Aj = jsparse.circuit_jacobian(**MATRIX)
    Asj = jax_fillin(Aj)
    want = jfact.leftlooking_numpy(Asj, Asj.filled_csc(Aj).data)
    got = leftlooking_numpy(As, vals0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_leftlooking_equals_rightlooking(filled):
    """Paper's claim: Alg. 2 computes the same LU as Alg. 1."""
    As, vals0 = filled
    np.testing.assert_allclose(leftlooking_numpy(As, vals0),
                               factorize_numpy(As, vals0), rtol=1e-12,
                               atol=1e-12)
    # the input is left as it is
    assert np.array_equal(vals0, filled[1])


# -- the CLI ---------------------------------------------------------------

def test_cli_matches_reference(capsys):
    argv = ["--nx", "4", "--ny", "4", "--t-end", "0.02", "--dt", "0.005"]
    got = tsim.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    want = jsim.main(argv)
    np.testing.assert_allclose(got.voltages, want.voltages, rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_array_equal(got.newton_iters, want.newton_iters)
    assert got.n_factorizations == want.n_factorizations
    assert len(lines) == 2
    assert lines[0] == (f"nodes: 16  steps: {len(want.times)}  newton: "
                        f"{want.newton_iters.sum()}  factorizations: "
                        f"{want.n_factorizations}")
    assert lines[1].startswith("setup ") and "max residual" in lines[1]


def test_cli_pallas_flag_is_a_no_op():
    argv = ["--nx", "3", "--ny", "3", "--t-end", "0.01", "--dt", "0.005",
            "--device", "cpu", "--no-diodes"]
    a = tsim.main(argv)
    b = tsim.main(argv + ["--pallas"])
    assert np.array_equal(a.voltages, b.voltages)
