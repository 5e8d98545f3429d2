"""The benchmark's frozen copies against the port as it stands: the matrix
generators and the Newton rule give the same bytes, and the counting rule
gives the brute-force count of updates and the port's plan's count."""
import numpy as np
import pytest

from portbench import counting
from portbench.harness import Bench
from portbench.matrix import Matrix

BENCH = Bench()


def _same(frozen: Matrix, port) -> None:
    from repro_torch.sparse import pattern_digest

    assert frozen.n == port.n
    for a, b in ((frozen.indptr, port.indptr), (frozen.indices, port.indices),
                 (frozen.data, np.asarray(port.data))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (pattern_digest(frozen.indptr, frozen.indices)
            == pattern_digest(port.indptr, port.indices))


@pytest.mark.parametrize("nx,ny,seed", [(128, 128, 0), (9, 5, 3)])
def test_grid_laplacian_bytes(nx, ny, seed):
    from repro_torch.sparse import grid_laplacian

    _same(BENCH.rule("grid_laplacian").build(nx=nx, ny=ny, leak=1e-3, seed=seed),
          grid_laplacian(nx, ny, seed=seed))


def _circuit(n, deg, seed) -> Matrix:
    """A random sparse circuit Jacobian from the port, as a small matrix
    whose pattern is not a grid's."""
    from repro_torch.sparse import circuit_jacobian

    A = circuit_jacobian(n, avg_degree=deg, seed=seed)
    return Matrix(A.n, np.asarray(A.indptr), np.asarray(A.indices), np.asarray(A.data))


@pytest.mark.parametrize("omega", [1e3, 31.6])
def test_ac_capacitance_bytes(omega):
    from repro_torch.sparse import ac_jacobian

    G = _circuit(300, 4.0, 5)
    c = BENCH.rule("ac_capacitance").build(G, cap_coupling=0.25, seed=5)
    _same(Matrix(G.n, G.indptr, G.indices, G.data + 1j * omega * c),
          ac_jacobian(300, omega=omega, avg_degree=4.0, seed=5))


def test_newton_rule_is_chip_smokes():
    import chip_smoke
    from repro_torch.sparse import circuit_jacobian

    A = circuit_jacobian(200, avg_degree=5.0, seed=1)
    mine = BENCH.rule("newton").perturb(
        Matrix(A.n, A.indptr, A.indices, np.asarray(A.data)), A.data,
        np.random.default_rng(9))
    theirs = chip_smoke.newton_values(A, np.random.default_rng(9))
    assert mine.tobytes() == theirs.tobytes()


def test_peaks_are_chip_smokes():
    import chip_smoke

    assert counting.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    assert counting.PEAK_OPS_PER_S == chip_smoke.PEAK_OPS_PER_S["float64"]


def _port_plan(A: Matrix):
    from repro_torch.core import plan_factorization
    from repro_torch.sparse import CSC

    return plan_factorization(CSC(A.n, A.indptr, A.indices, A.data), cache=None)[0]


def _eliminate(n, indptr, indices):
    """Right-looking elimination on a boolean pattern, fill created as it
    goes: the updates made and the filled pattern."""
    M = np.zeros((n, n), dtype=bool)
    cols = np.repeat(np.arange(n), np.diff(indptr))
    M[indices, cols] = True
    updates = 0
    for k in range(n):
        rows = np.flatnonzero(M[k + 1:, k]) + k + 1
        right = np.flatnonzero(M[k, k + 1:]) + k + 1
        for i in rows:
            for j in right:
                M[i, j] = True
                updates += 1
    return updates, M


@pytest.mark.parametrize("make", [lambda: _circuit(60, 4.0, 2),
                                  lambda: BENCH.rule("grid_laplacian").build(nx=6, ny=5, seed=1)],
                         ids=["circuit", "grid"])
def test_update_triples_brute_force(make):
    A = make()
    plan = _port_plan(A)
    updates, M = _eliminate(A.n, plan.perm_indptr, plan.perm_indices)
    P = plan.pattern
    filled = np.zeros_like(M)
    filled[P.indices, np.repeat(np.arange(P.n), np.diff(P.indptr))] = True
    assert (filled == M).all()
    assert counting.update_triples(P.n, P.indptr, P.indices) == updates
    assert updates == plan.fplan.total_updates


def test_update_triples_grid64_against_the_plan():
    A = BENCH.rule("grid_laplacian").build(nx=64, ny=64, seed=0)
    plan = _port_plan(A)
    P = plan.pattern
    assert counting.update_triples(P.n, P.indptr, P.indices) == 2_775_837
    assert plan.fplan.total_updates == 2_775_837


@pytest.mark.parametrize("ordering,filled,triples", [("mindeg", 818_242, 36_281_855),
                                                     ("auto", 2_828_672, 135_599_424)])
def test_update_triples_grid128(monkeypatch, ordering, filled, triples):
    """grid128's count from the port's filled pattern, at the cell's
    ordering and at the port's default (RCM at this size); the plan's own
    update arrays are not built here."""
    import repro_torch.core.planner as planner
    from repro_torch.core import plan_factorization
    from repro_torch.sparse import CSC

    seen = {}

    def pattern_only(pattern, levelization, panel_threshold=16):
        seen["p"] = pattern

    monkeypatch.setattr(planner, "build_plan", pattern_only)
    A = BENCH.rule("grid_laplacian").build(nx=128, ny=128, seed=0)
    plan_factorization(CSC(A.n, A.indptr, A.indices, A.data), ordering=ordering, cache=None)
    P = seen["p"]
    assert P.nnz == filled
    assert counting.update_triples(P.n, P.indptr, P.indices) == triples


def _solve_entries(n, indptr, indices, support):
    """Factor entries a solve touches, by walking it: forward over L from
    the support, backward over U from what that reached."""
    cols = np.repeat(np.arange(n), np.diff(indptr))
    live = np.zeros(n, dtype=bool)
    live[support] = True
    used = 0
    for j in range(n):
        if live[j]:
            below = indices[(cols == j) & (indices > j)]
            used += len(below)
            live[below] = True
    for j in range(n - 1, -1, -1):
        if live[j]:
            upper = indices[(cols == j) & (indices <= j)]
            used += len(upper)
            live[upper] = True
    return used


@pytest.mark.parametrize("support", [None, [3], [0, 17, 40]])
def test_solve_work_brute_force(support):
    A = _circuit(60, 3.0, 4)
    P = _port_plan(A).pattern
    w = counting.solve_work(P.n, P.indptr, P.indices, False, batch=3,
                            support=None if support is None else np.array(support))
    entries = (P.nnz if support is None
               else _solve_entries(P.n, P.indptr, P.indices, np.array(support)))
    assert w.ops == 3 * 2 * entries
    assert w.bytes == 3 * (entries * 8 + 2 * P.n * 8) + 4 * entries


def test_factor_work_counts():
    A = BENCH.rule("grid_laplacian").build(nx=6, ny=6, seed=0)
    P = _port_plan(A).pattern
    triples = counting.update_triples(P.n, P.indptr, P.indices)
    n_l = int((P.indices > np.repeat(np.arange(P.n), np.diff(P.indptr))).sum())
    real = counting.factor_work(P.n, P.indptr, P.indices, A.nnz, False, batch=2)
    cplx = counting.factor_work(P.n, P.indptr, P.indices, A.nnz, True, batch=1)
    assert real.ops == 2 * (2 * triples + n_l)
    assert real.bytes == 2 * (2 * P.nnz + A.nnz) * 8 + 4 * P.nnz
    assert cplx.ops == 8 * triples + n_l
    assert cplx.bytes == (2 * P.nnz + A.nnz) * 16 + 4 * P.nnz
    assert real.least_s() == max(real.ops / 67e12, real.bytes / 3.35e12)
