"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs (with a batch axis too), and the GLU facade end
to end, single and batched.  Every test
needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere; run them there
with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import GLU
from repro_torch.kernels import (
    dense_lu,
    dense_lu_planar,
    level_run,
    segmented_accumulate,
)
from repro_torch.kernels.level_update import random_level_run
from repro_torch.kernels.ref import (
    dense_lu_planar_ref,
    dense_lu_ref,
    level_run_ref,
    lu_backward_error,
)
from repro_torch.sparse import ac_jacobian, circuit_jacobian

pytestmark = pytest.mark.cuda

K2_TOL = {torch.float32: 5e-3, torch.float64: 1e-9}


@pytest.fixture
def cuda():
    # decided here, never at import: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


# multi-level runs at the path's shapes (grid64's widest levels;
# rajat12_like's D up to 801, R up to 2,355, C 794), a row of more than
# 1,024 slots split over work items, and a one-level run
K1_RUNS = {
    "grid64": [(905, 90, 297), (710, 135, 297), (392, 199, 297), (56, 40, 150)],
    "rajat12": [(801, 2355, 794), (723, 1200, 794)],
    "split": [(3, 768, 2100), (4, 300, 1100)],
    "one-level": [(1, 90, 270)],
}
K1_DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]


def _check_run(run, vals):
    """One launch on the counter, bit-identity with the plain version on
    the same values, and a bit-identical repeat."""
    got, again, want = vals.clone(), vals.clone(), vals.clone()
    before = level_run.launches
    level_run(got, run)
    torch.cuda.synchronize()
    assert level_run.launches == before + 1
    level_run(again, run)
    level_run_ref(want, run)
    torch.cuda.synchronize()
    assert not torch.equal(got, vals)
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    return got


@pytest.mark.parametrize("shapes", list(K1_RUNS), ids=list(K1_RUNS))
@pytest.mark.parametrize("dtype", K1_DTYPES)
def test_k1_matches_plain(cuda, shapes, dtype):
    run, vals = random_level_run(np.random.default_rng(len(shapes)),
                                 K1_RUNS[shapes], dtype, cuda)
    _check_run(run, vals)


@pytest.mark.parametrize("dtype", K1_DTYPES)
def test_k1_duplicates_and_determinism(cuda, dtype):
    """Every update of a row on the segment's first slot, R = 2,355 (three
    tiles): one fixed-order sum a row, the same bits as the plain version
    and on a repeat; ones into zeros count the updates exactly."""
    run, vals = random_level_run(np.random.default_rng(3),
                                 [(64, 2355, 128), (32, 700, 64)], dtype,
                                 cuda, duplicates=True)
    _check_run(run, vals)
    ones, _ = random_level_run(np.random.default_rng(4), [(16, 2355, 8)],
                               dtype, cuda, duplicates=True)
    v = torch.ones(ones.n_vals, dtype=dtype, device=cuda)
    seg = torch.from_numpy(ones.host["rows"][:, 0]).to(cuda)
    v[seg] = 0
    level_run(v, ones)
    # each contribution is -(1 / 1) * 1
    assert bool((v[seg] == -2355).all())


def test_k1_refuses_other_devices_and_dtypes(cuda):
    run, vals = random_level_run(np.random.default_rng(5), [(3, 4, 5)],
                                 torch.float64, cuda)
    with pytest.raises(ValueError, match="cuda or cpu"):
        level_run(torch.empty_like(vals, device="meta"), run)
    with pytest.raises(ValueError):
        level_run(vals.cpu(), run)              # the run lies on the card
    with pytest.raises(TypeError):
        level_run(vals.to(torch.float16), run)
    with pytest.raises(ValueError):
        level_run(vals[: run.n_vals - 1], run)  # shorter than the run needs
    with pytest.raises(NotImplementedError, match="level_run"):
        segmented_accumulate(vals.view(1, -1), vals.view(1, -1),
                             torch.zeros((1, vals.numel()), dtype=torch.int32,
                                         device=cuda))


def _check_dense_lu(kernel, plain, a, N):
    """One call: one launch on the counter, ``a`` untouched, agreement with
    the plain version and the componentwise backward error, and a second
    call bit-identical to the first."""
    a0 = a.clone()
    before = kernel.launches
    got = kernel(a)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(a, a0)
    tol = K2_TOL[a.dtype]
    torch.testing.assert_close(got, plain(a), rtol=tol, atol=tol)
    # L's entries (about 1/N) lie below the f32 tolerance: hold L to the
    # reconstruction too
    assert lu_backward_error(a, got) <= 4.0 * N * torch.finfo(a.dtype).eps
    assert torch.equal(kernel(a), got)
    assert kernel.launches == before + 2


# N = 32 is a single block; N = 2048 has more update blocks than the card
# keeps resident CTAs
@pytest.mark.parametrize("N", [32, 64, 128, 160, 256, 736, 768, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_matches_plain(cuda, N, dtype):
    rng = np.random.default_rng(N)
    a = torch.from_numpy(rng.normal(size=(N, N)) + N * np.eye(N)).to(cuda, dtype)
    _check_dense_lu(dense_lu, dense_lu_ref, a, N)


@pytest.mark.parametrize("N", [32, 96, 736, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_matches_plain(cuda, N, dtype):
    rng = np.random.default_rng(N + 1)
    a = rng.normal(size=(2, N, N))
    a[0] += N * np.eye(N)
    a = torch.from_numpy(a).to(cuda, dtype)
    # the complex backward error sees a wrong L that the tolerance cannot
    _check_dense_lu(dense_lu_planar, dense_lu_planar_ref, a, N)


def test_wrappers_check_their_inputs(cuda):
    run, vals = random_level_run(np.random.default_rng(7), [(2, 8, 16)],
                                 torch.float64, cuda)
    with pytest.raises(TypeError):
        level_run(vals.to(torch.int64), run)
    with pytest.raises(ValueError):
        level_run(torch.stack([vals, vals], 1)[:, 0], run)   # not contiguous
    with pytest.raises(ValueError):
        dense_lu(torch.zeros((48, 48), dtype=torch.float64, device=cuda))
    planes = torch.zeros((2, 64, 64), dtype=torch.float64, device=cuda)
    for bad, exc in ((planes[:, :48, :48], ValueError),
                     (planes[0], ValueError),
                     (torch.zeros((3, 64, 64), dtype=torch.float64,
                                  device=cuda), ValueError),
                     (planes.to(torch.complex128), TypeError),
                     (planes.to(torch.float16), TypeError)):
        with pytest.raises(exc):
            dense_lu_planar(bad)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dense_lu_planar(torch.empty((2, 64, 64), dtype=torch.float64,
                                    device="meta"))


def test_glu_on_card_matches_cpu(cuda):
    A = circuit_jacobian(300, avg_degree=4.0, seed=0)
    b = np.random.default_rng(1).normal(size=A.n)
    g_cpu = GLU(A, device="cpu")
    x_cpu = g_cpu.factorize().solve(b, refine=2)
    k1, k2 = level_run.launches, dense_lu.launches
    g = GLU(A)
    x = g.factorize().solve(b, refine=2)
    kinds = g._factorizer.step_kinds
    assert level_run.launches - k1 == kinds.count("run") > 0
    assert dense_lu.launches - k2 == kinds.count("dense") == 1
    assert g.solve_info["kernels_disabled_reason"] is None
    np.testing.assert_allclose(x, x_cpu, rtol=1e-9, atol=1e-9)
    assert g.residual(b, x) < 1e-9
    v1 = g.factorize(A.data).factorized_values().clone()
    v2 = g.factorize(A.data).factorized_values()
    assert torch.equal(v1, v2)


def test_complex_glu_on_card_matches_cpu(cuda):
    A = ac_jacobian(300, avg_degree=4.0, seed=0)
    rng = np.random.default_rng(1)
    b = rng.normal(size=A.n) + 1j * rng.normal(size=A.n)
    g_cpu = GLU(A, dtype=torch.complex128, device="cpu")
    x_cpu = g_cpu.factorize().solve(b, refine=2)
    k1, k2, k3 = (level_run.launches, dense_lu.launches,
                  dense_lu_planar.launches)
    g = GLU(A, dtype=torch.complex128)
    x = g.factorize().solve(b, refine=2)
    kinds = g._factorizer.step_kinds
    assert level_run.launches - k1 == kinds.count("run") > 0
    assert dense_lu_planar.launches - k3 == kinds.count("dense") == 1
    assert dense_lu.launches == k2
    info = g.solve_info
    assert info["kernels_disabled_reason"] is None
    assert info["layout"] == "planar" and info["converged"]
    np.testing.assert_allclose(x, x_cpu, rtol=1e-9, atol=1e-9)
    assert g.residual(b, x) < 1e-9
    v1 = g.factorize(A.data).factorized_values().clone()
    v2 = g.factorize(A.data).factorized_values()
    assert v1.dtype == torch.complex128 and torch.equal(v1, v2)
    torch.testing.assert_close(v1.cpu(), g_cpu.factorized_values(),
                               rtol=1e-10, atol=1e-10)


def test_native_complex_glu_on_card(cuda):
    """Complex values in the native layout on the card: no K1 launch, one
    K3 launch a factorization, the replay bit for bit the steps one by
    one, the CPU run and the planar route to tolerance; a batch's rows
    bit for bit the single GLU's."""
    A = ac_jacobian(300, avg_degree=4.0, seed=0)
    rng = np.random.default_rng(1)
    b = rng.normal(size=A.n) + 1j * rng.normal(size=A.n)
    x_cpu = GLU(A, dtype=torch.complex128, layout="native",
                device="cpu").factorize().solve(b, refine=2)
    g = GLU(A, dtype=torch.complex128, layout="native")
    ge = GLU(A, dtype=torch.complex128, layout="native", jit_schedule=False)
    g.factorize()
    k1, k3 = level_run.launches, dense_lu_planar.launches
    x = g.factorize().solve(b, refine=2)
    assert level_run.launches == k1 and dense_lu_planar.launches == k3 + 1
    assert g.solve_info["n_dispatches"] == 1
    assert "layout='native'" in g.solve_info["kernels_disabled_reason"]
    xe = ge.factorize().solve(b, refine=2)
    assert torch.equal(g.factorized_values(), ge.factorized_values())
    assert x.tobytes() == xe.tobytes() and g.residual(b, x) < 1e-9
    np.testing.assert_allclose(x, x_cpu, rtol=1e-9, atol=1e-9)
    gp = GLU(A, dtype=torch.complex128).factorize()
    torch.testing.assert_close(g.factorized_values(), gp.factorized_values(),
                               rtol=1e-12, atol=1e-14)
    vals = np.asarray(A.data)[None] * rng.uniform(0.95, 1.05, (3, A.nnz))
    fb = g.factorize_batched(vals).factorized_values_batched()
    for k in range(3):
        assert torch.equal(fb[k], ge.factorize(vals[k]).factorized_values())


# -- CUDA graphs and static pivoting ---------------------------------------

def _graph_and_eager(A, dtype, b, **kw):
    """The same matrix through ``jit_schedule`` True (one replay per
    factorization and per solve) and False (the steps one by one)."""
    rng = np.random.default_rng(11)
    new = [np.asarray(A.data) * rng.uniform(0.95, 1.05, size=A.nnz)
           for _ in range(3)]
    out = {}
    for jit in (True, False):
        g = GLU(A, dtype=dtype, jit_schedule=jit, **kw)
        rows = []
        for vals in new:
            g.factorize(vals)
            disp = g.solve_info["n_dispatches"]
            rows.append((g.factorized_values(), g.solve(b),
                         g.solve_info["solve_dispatches"],
                         g.solve(b, refine=3), g.solve_info, disp))
        out[jit] = (g, rows)
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_graph_replays_equal_eager_steps(cuda, dtype):
    """Factors, solutions and refined solutions of the replays equal the
    eager steps' bit for bit; after the first (warm-up) call each
    factorization and each unrefined solve is one dispatch."""
    A = (ac_jacobian(300, avg_degree=4.0, seed=0) if dtype.is_complex
         else circuit_jacobian(300, avg_degree=4.0, seed=0))
    rng = np.random.default_rng(1)
    b = rng.normal(size=A.n) + (1j * rng.normal(size=A.n)
                                if dtype.is_complex else 0.0)
    out = _graph_and_eager(A, dtype, b)
    (g, graph), (_, eager) = out[True], out[False]
    for i, (got, want) in enumerate(zip(graph, eager)):
        assert torch.equal(got[0], want[0])
        assert got[1].tobytes() == want[1].tobytes()
        assert got[3].tobytes() == want[3].tobytes()
        assert got[4]["refine_iters"] == want[4]["refine_iters"]
        if i:
            assert got[5] == 1 and got[2] == 1
        assert want[5] == 1 + g._factorizer.n_groups
    # refined, after a factorization: the |A| pass, the solve's replay,
    # then one replay and one read per chunk of sweeps
    info = graph[-1][4]
    assert info["solve_dispatches"] == 2 + 2 * info["host_syncs"]


def test_replays_count_kernel_launches(cuda):
    """Each replay adds the graph's launches to the kernels' counts: one
    K1 launch per run and one K2 launch per factorization."""
    A = circuit_jacobian(300, avg_degree=4.0, seed=0)
    g = GLU(A)
    g.factorize()
    runs = g._factorizer.step_kinds.count("run")
    k1, k2 = level_run.launches, dense_lu.launches
    for _ in range(4):
        g.factorize(A.data)
    torch.cuda.synchronize()
    assert level_run.launches - k1 == 4 * runs and dense_lu.launches - k2 == 4
    assert g.solve_info["n_dispatches"] == 1


def test_capture_of_both_cooperative_kernels(cuda):
    """K1 and K2 (cooperative launches) record into one CUDA graph; its
    replay gives the eager launches' bits."""
    from repro_torch.core.executor import CapturedSchedule

    run, vals = random_level_run(np.random.default_rng(2),
                                 K1_RUNS["grid64"], torch.float64, cuda)
    a = torch.from_numpy(np.random.default_rng(3).normal(size=(160, 160))
                         + 160 * np.eye(160)).to(cuda)
    v0, buf, out = vals.clone(), vals.clone(), {}

    def program():
        buf.copy_(v0)
        level_run(buf, run)
        out["lu"] = dense_lu(a)

    want = level_run(vals.clone(), run)
    want_lu = dense_lu(a)
    cap = CapturedSchedule(program, cuda, eager_steps=3)
    assert cap() == 3 and cap.graph is not None
    assert cap.launches == {level_run: 1, dense_lu: 1}
    buf.zero_()
    assert cap() == 1
    torch.cuda.synchronize()
    assert torch.equal(buf, want) and torch.equal(out["lu"], want_lu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_robust_k1_matches_plain(cuda, dtype):
    """The robust instantiation bumps each level's diagonals after the
    level's barrier, bit for bit and bump for bump as its plain version,
    with bumps in several levels; a repeat gives the same bits."""
    run, vals = random_level_run(np.random.default_rng(6), K1_RUNS["grid64"],
                                 dtype, cuda)
    h = run.host
    rng = np.random.default_rng(7)
    crushed = []
    for k in range(run.n_levels):
        d = h["diag"][h["diag_ptr"][k]:h["diag_ptr"][k + 1]]
        crushed.append(rng.choice(d, size=min(5, len(d)), replace=False))
    crushed = torch.from_numpy(np.concatenate(crushed)).to(cuda)
    vals[crushed] = torch.from_numpy(rng.uniform(-1e-6, 1e-6, len(crushed))
                                     ).to(cuda, dtype)
    tau = torch.tensor(1e-3, dtype=dtype, device=cuda)
    outs = []
    for fn in (level_run, level_run, level_run_ref):
        v = vals.clone()
        count = torch.zeros((), dtype=torch.int32, device=cuda)
        fn(v, run, tau, count)
        torch.cuda.synchronize()
        outs.append((v, int(count)))
    (got, n), (again, n2), (want, n_want) = outs
    assert n == n2 == n_want == len(crushed)
    assert torch.equal(got, want) and torch.equal(again, got)
    plain = level_run(vals.clone(), run)
    assert not torch.equal(plain, got)


def test_static_pivot_graph_equals_eager(cuda):
    """GLU(static_pivot) on an unscaled ill-conditioned matrix: the
    replays' factors, solutions and bump counts equal the eager steps'."""
    from repro_torch.sparse import ill_conditioned_jacobian

    A = ill_conditioned_jacobian(150, decades=0.0, tiny_pivots=3, seed=5)
    b = np.random.default_rng(4).normal(size=A.n)
    out = _graph_and_eager(A, torch.float64, b, static_pivot=1e-10,
                           mc64="none")
    for got, want in zip(out[True][1], out[False][1]):
        assert torch.equal(got[0], want[0])
        assert got[1].tobytes() == want[1].tobytes()
    assert out[True][0].solve_info["n_perturbed"] == \
        out[False][0].solve_info["n_perturbed"] == 2


def test_transient_graph_equals_eager(cuda):
    """The Newton transient on the card: replays and eager steps give the
    same voltages bit for bit, and the CPU run's to 1e-9."""
    from repro_torch.circuit import rc_grid_circuit, transient

    ckt = rc_grid_circuit(8, 8, with_diodes=True, seed=0)
    kw = dict(t_end=0.02, dt=0.005, refine=1)
    graph = transient(ckt, **kw)
    eager = transient(ckt, jit_schedule=False, **kw)
    cpu = transient(ckt, device="cpu", **kw)
    assert graph.voltages.tobytes() == eager.voltages.tobytes()
    np.testing.assert_allclose(graph.voltages, cpu.voltages, rtol=1e-9,
                               atol=1e-9)
    assert graph.max_residual < 1e-8
    assert graph.n_factorizations == graph.newton_iters.sum()
    assert graph.ladder_counts == dict(refactorize=graph.n_factorizations,
                                       rescale=0, bump=0, replan=0)


# -- the batched engine: B matrices on one plan -------------------------------

@pytest.mark.parametrize("dtype", K1_DTYPES)
def test_batched_k1_matches_plain(cuda, dtype):
    """One launch for a (B, n) batch: each matrix bit for bit as its plain
    version and as a launch on it alone, and a bit-identical repeat."""
    shapes = K1_RUNS["grid64"]
    run, _ = random_level_run(np.random.default_rng(8), shapes, dtype, cuda)
    vals = torch.stack([random_level_run(np.random.default_rng(9 + b), shapes,
                                         dtype, cuda)[1] for b in range(5)])
    got, again, want = vals.clone(), vals.clone(), vals.clone()
    before = level_run.launches
    level_run(got, run)
    torch.cuda.synchronize()
    assert level_run.launches == before + 1
    level_run(again, run)
    level_run_ref(want, run)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)
    for b in range(5):
        assert torch.equal(level_run(vals[b].clone(), run), got[b]), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_robust_k1_matches_plain(cuda, dtype):
    """Per-matrix tau and (B,) bump counts, bit for bit and bump for bump
    as the plain version; a matrix with nothing to bump counts 0."""
    run, vals = random_level_run(np.random.default_rng(6), K1_RUNS["grid64"],
                                 dtype, cuda)
    vals = torch.stack([vals] * 4)
    diag = torch.from_numpy(run.host["diag"]).to(cuda)
    rng = np.random.default_rng(7)
    for b in (0, 2, 3):
        pick = torch.from_numpy(rng.choice(len(diag), size=5 * (b + 1),
                                           replace=False)).to(cuda)
        vals[b, diag[pick]] = 1e-9
    tau = torch.tensor([1e-3, 1e-3, 1e-3, 1e-12], dtype=dtype, device=cuda)
    outs = []
    for fn in (level_run, level_run, level_run_ref):
        v = vals.clone()
        count = torch.zeros(4, dtype=torch.int32, device=cuda)
        fn(v, run, tau, count)
        torch.cuda.synchronize()
        outs.append((v, count.tolist()))
    (got, n), (again, n2), (want, n_want) = outs
    assert n == n2 == n_want == [5, 0, 15, 0]
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.parametrize("N", [32, 160, 736])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("planar", [False, True], ids=["K2", "K3"])
def test_batched_dense_lu_equals_single_tiles(cuda, N, dtype, planar):
    """B tiles in one launch: each tile bit for bit as the single-tile
    launch (the same blocks in the same order), within the stated
    tolerance of the plain version, ``a`` untouched."""
    rng = np.random.default_rng(N)
    shape = (5, 2, N, N) if planar else (5, N, N)
    a = rng.normal(size=shape)
    (a[:, 0] if planar else a)[...] += N * np.eye(N)
    a = torch.from_numpy(a).to(cuda, dtype)
    a0 = a.clone()
    kernel = dense_lu_planar if planar else dense_lu
    plain = dense_lu_planar_ref if planar else dense_lu_ref
    before = kernel.launches
    got = kernel(a)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and torch.equal(a, a0)
    assert torch.equal(kernel(a), got)
    tol = K2_TOL[dtype]
    for b in range(5):
        assert torch.equal(kernel(a[b]), got[b]), b
    torch.testing.assert_close(got, plain(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_batched_replays_equal_eager_steps(cuda, dtype):
    """factorize_batched and solve_batched: one replay each after the
    first call, bit for bit the steps one by one and the single GLU's
    factors and solutions a matrix, and the CPU's to tolerance."""
    A = (ac_jacobian(300, avg_degree=4.0, seed=0) if dtype.is_complex
         else circuit_jacobian(300, avg_degree=4.0, seed=0))
    rng = np.random.default_rng(12)
    batch = np.asarray(A.data)[None] * (1 + 0.1 * rng.uniform(-1, 1, (4, A.nnz)))
    bs = rng.normal(size=(4, A.n)) + (1j * rng.normal(size=(4, A.n))
                                      if dtype.is_complex else 0.0)
    sets = [batch * s for s in (1.0, 1.01, 1.02)]
    g = GLU(A, dtype=dtype)
    ge = GLU(A, dtype=dtype, jit_schedule=False)
    g1 = GLU(A, dtype=dtype)
    kinds = g._factorizer.step_kinds
    for i, vals in enumerate(sets):
        k1, kd = level_run.launches, dense_lu.launches + dense_lu_planar.launches
        x = g.factorize_batched(vals).solve_batched(bs)
        disp = (g.solve_info["n_dispatches"], g.solve_info["solve_dispatches"])
        assert level_run.launches - k1 == kinds.count("run")
        assert (dense_lu.launches + dense_lu_planar.launches - kd
                == kinds.count("dense"))
        xe = ge.factorize_batched(vals).solve_batched(bs)
        assert torch.equal(g.factorized_values_batched(),
                           ge.factorized_values_batched())
        assert x.tobytes() == xe.tobytes()
        if i:
            assert disp == (1, 1)
    factors = g.factorized_values_batched()
    for b in range(4):
        x1 = g1.factorize(sets[2][b]).solve(bs[b])
        assert torch.equal(g1.factorized_values(), factors[b])
        assert x1.tobytes() == x[b].tobytes()
    xr = g.solve_batched(bs, refine=2)
    assert xr.tobytes() == ge.solve_batched(bs, refine=2).tobytes()
    assert g.solve_info["converged"].all()
    gc = GLU(A, dtype=dtype, device="cpu")
    xc = gc.factorize_batched(sets[2]).solve_batched(bs, refine=2)
    np.testing.assert_allclose(xr, xc, rtol=1e-9, atol=1e-9)


def test_batched_static_pivot_on_card(cuda):
    """The batched robust K1 inside the replay: per-matrix bump counts
    equal the steps one by one and the single GLU's."""
    from repro_torch.sparse import ill_conditioned_jacobian

    A = ill_conditioned_jacobian(150, decades=0.0, tiny_pivots=3, seed=5)
    rng = np.random.default_rng(13)
    batch = np.asarray(A.data)[None] * (1 + 0.05 * rng.uniform(-1, 1, (3, A.nnz)))
    kw = dict(static_pivot=1e-10, mc64="none")
    g, ge, g1 = GLU(A, **kw), GLU(A, jit_schedule=False, **kw), GLU(A, **kw)
    for _ in range(2):
        g.factorize_batched(batch)
    ge.factorize_batched(batch)
    n, ne = g.solve_info["n_perturbed"], ge.solve_info["n_perturbed"]
    assert n.tolist() == ne.tolist() and (n > 0).all()
    assert torch.equal(g.factorized_values_batched(),
                       ge.factorized_values_batched())
    for b in range(3):
        g1.factorize(batch[b])
        assert g1.solve_info["n_perturbed"] == n[b]
        assert torch.equal(g1.factorized_values(),
                           g.factorized_values_batched()[b])


def test_transient_sweep_on_card(cuda):
    """The lockstep sweep on the card: replays and eager steps give the
    same voltages bit for bit, and the CPU run's to 1e-9."""
    from repro_torch.circuit import rc_grid_circuit, transient_sweep

    ckt = rc_grid_circuit(8, 8, with_diodes=True, seed=0)
    kw = dict(t_end=0.02, dt=0.005, scales=[0.9, 1.0, 1.1], refine=1)
    graph = transient_sweep(ckt, **kw)
    eager = transient_sweep(ckt, jit_schedule=False, **kw)
    cpu = transient_sweep(ckt, device="cpu", **kw)
    assert graph.voltages.tobytes() == eager.voltages.tobytes()
    np.testing.assert_allclose(graph.voltages, cpu.voltages, rtol=1e-9,
                               atol=1e-9)
    assert graph.max_residual < 1e-8
    assert graph.n_batched_factorizations == graph.newton_iters.sum()


# -- complex static pivoting, pruned and many-RHS solves, the AC sweep -----

def _crush_by_magnitude(run, vals, rng, per_level=5):
    """Up to ``per_level`` of each level's column diagonals scaled to below
    1e-6 in magnitude, phase kept, the first of them an exact zero; returns
    how many."""
    h = run.host
    picks = []
    for k in range(run.n_levels):
        d = h["diag"][h["diag_ptr"][k]:h["diag_ptr"][k + 1]]
        picks.append(rng.choice(d, size=min(per_level, len(d)), replace=False))
    picks = torch.from_numpy(np.concatenate(picks)).to(vals.device)
    scale = torch.from_numpy(rng.uniform(1e-9, 1e-6, len(picks))).to(
        vals.device, vals.real.dtype)
    vals[picks] = vals[picks] / vals[picks].abs() * scale
    vals[picks[0]] = 0.0
    return len(picks)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_robust_complex_k1_matches_plain(cuda, dtype):
    """The complex robust instantiation (tau real, phase kept) bit for bit
    and bump for bump as its plain version on the card, a repeat giving
    the same bits."""
    run, vals = random_level_run(np.random.default_rng(6), K1_RUNS["grid64"],
                                 dtype, cuda)
    n_crushed = _crush_by_magnitude(run, vals, np.random.default_rng(7))
    tau = torch.tensor(1e-3, dtype=vals.real.dtype, device=cuda)
    outs = []
    for fn in (level_run, level_run, level_run_ref):
        v = vals.clone()
        count = torch.zeros((), dtype=torch.int32, device=cuda)
        fn(v, run, tau, count)
        torch.cuda.synchronize()
        outs.append((v, int(count)))
    (got, n), (again, n2), (want, n_want) = outs
    assert n == n2 == n_want == n_crushed
    assert torch.equal(got, want) and torch.equal(again, got)
    with pytest.raises(ValueError, match="real dtype"):
        level_run(vals.clone(), run, tau.to(dtype),
                  torch.zeros((), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_batched_robust_complex_k1_matches_plain(cuda, dtype):
    """B = 4 with per-matrix real tau: (B,) bump counts and values bit for
    bit as the plain version; a matrix with nothing to bump counts 0."""
    run, vals = random_level_run(np.random.default_rng(6), K1_RUNS["grid64"],
                                 dtype, cuda)
    vals = torch.stack([vals] * 4)
    counts = [_crush_by_magnitude(run, vals[b], np.random.default_rng(b),
                                  per_level=b + 1) if b != 1 else 0
              for b in range(4)]
    tau = torch.tensor([1e-3, 1e-3, 1e-3, 1e-12], dtype=vals.real.dtype,
                       device=cuda)
    outs = []
    for fn in (level_run, level_run, level_run_ref):
        v = vals.clone()
        count = torch.zeros(4, dtype=torch.int32, device=cuda)
        fn(v, run, tau, count)
        torch.cuda.synchronize()
        outs.append((v, count.tolist()))
    (got, n), (again, n2), (want, n_want) = outs
    assert n == n2 == n_want
    assert n[:3] == counts[:3] and n[3] <= counts[3]
    assert torch.equal(got, want) and torch.equal(again, got)


def test_complex_static_pivot_graph_equals_eager(cuda):
    """GLU(complex128, static_pivot) with bumps in the flat levels, the K1
    run and the dense tail: the replays' factors, solutions and bump
    counts equal the eager steps', single and batched."""
    A = ac_jacobian(300, avg_degree=4.5, seed=11)
    rng = np.random.default_rng(4)
    b = rng.normal(size=A.n) + 1j * rng.normal(size=A.n)
    out = _graph_and_eager(A, torch.complex128, b, static_pivot=0.3,
                           mc64="none")
    for got, want in zip(out[True][1], out[False][1]):
        assert torch.equal(got[0], want[0])
        assert got[1].tobytes() == want[1].tobytes()
    n = out[True][0].solve_info["n_perturbed"]
    assert n == out[False][0].solve_info["n_perturbed"] > 0
    batch = np.asarray(A.data)[None] * (1 + 0.05 * rng.uniform(-1, 1,
                                                               (3, A.nnz)))
    kw = dict(dtype=torch.complex128, static_pivot=0.3, mc64="none")
    g, ge = GLU(A, **kw), GLU(A, jit_schedule=False, **kw)
    for _ in range(2):
        g.factorize_batched(batch)
    ge.factorize_batched(batch)
    assert g.solve_info["n_perturbed"].tolist() == \
        ge.solve_info["n_perturbed"].tolist()
    assert torch.equal(g.factorized_values_batched(),
                       ge.factorized_values_batched())


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_pruned_and_multi_solves_on_card(cuda, dtype):
    """Pruned replays equal full replays bit for bit with exact zeros off
    the reach, and the pruned steps one by one; solve_multi rows equal
    single solves; solve_batched with a pattern equals the unpruned
    batched solve."""
    cplx = dtype.is_complex
    A = (ac_jacobian(300, avg_degree=4.0, seed=0) if cplx
         else circuit_jacobian(300, avg_degree=4.0, seed=0))
    rng = np.random.default_rng(8)
    g, ge = GLU(A, dtype=dtype), GLU(A, dtype=dtype, jit_schedule=False)
    g.factorize()
    ge.factorize()
    vals, sv = g._vals, g._solver
    for pat in ([7], [3, 150, 299]):
        b = np.zeros(A.n, dtype=np.complex128 if cplx else np.float64)
        b[pat] = rng.normal(size=len(pat))
        x_full, x = g.solve(b), g.solve(b)           # warm-up, then replays
        x_pruned = g.solve(b, rhs_pattern=pat)
        x_pruned = g.solve(b, rhs_pattern=pat)
        assert g.solve_info["solve_dispatches"] == 1
        assert np.array_equal(x, x_pruned) and np.array_equal(x_full, x)
        assert x_pruned.tobytes() == ge.solve(b, rhs_pattern=pat).tobytes()
        bp = (b * g.Dr)[g._inv_row]
        pp = g.row_map[np.asarray(pat)]
        xp = sv.solve(vals, bp, rhs_pattern=pp).cpu().numpy()
        _, _, _, breach = sv.schedule_for_pattern(pp)
        assert (xp[np.setdiff1d(np.arange(A.n), breach)] == 0).all()
    B = rng.normal(size=(16, A.n)) + (1j * rng.normal(size=(16, A.n))
                                      if cplx else 0.0)
    for _ in range(2):
        X = g.solve_multi(B)
    assert g.solve_info["solve_dispatches"] == 1
    for k in range(16):
        assert X[k].tobytes() == g.solve(B[k]).tobytes(), k
    batch = np.asarray(A.data)[None] * (1 + 0.05 * rng.uniform(-1, 1,
                                                               (8, A.nnz)))
    bs = np.zeros((8, A.n), dtype=B.dtype)
    bs[:, [3, 150]] = rng.normal(size=(8, 2))
    g.factorize_batched(batch)
    full = g.solve_batched(bs)
    for _ in range(2):
        pruned = g.solve_batched(bs, rhs_pattern=[3, 150])
    assert np.array_equal(full, pruned)


def test_ac_sweep_on_card(cuda):
    """The AC sweep on the card: one batched factorization, replays and
    eager steps give the same voltages bit for bit, the CPU run's to
    1e-9, backward error within the reference's bar."""
    from repro_torch.circuit import ac_sweep, rc_grid_circuit

    ckt = rc_grid_circuit(8, 8, with_diodes=True, seed=3)
    ckt.add_ac_current_source(5, 0, 1.0)
    freqs = np.logspace(0, 6, 25)
    k1, k3 = level_run.launches, dense_lu_planar.launches
    graph = ac_sweep(ckt, freqs)
    assert level_run.launches > k1 or dense_lu_planar.launches > k3
    eager = ac_sweep(ckt, freqs, jit_schedule=False)
    cpu = ac_sweep(ckt, freqs, device="cpu")
    assert graph.voltages.tobytes() == eager.voltages.tobytes()
    np.testing.assert_allclose(graph.voltages, cpu.voltages, rtol=1e-9,
                               atol=1e-9)
    assert graph.n_batched_factorizations == 1 and graph.op_converged
    assert graph.max_backward_error <= 1e-10
    pivot = ac_sweep(ckt, freqs, static_pivot=1e-10)
    np.testing.assert_allclose(pivot.voltages, cpu.voltages, rtol=1e-9,
                               atol=1e-9)


# -- plan verification and the mode ablation on the card --------------------

def test_glu_verify_full_audits_the_graphs(cuda):
    """``GLU(verify="full")`` runs the graph audit (not skipped), finds
    nothing, and leaves the GLU's factors and solutions bit for bit those
    of an unverified one."""
    A = circuit_jacobian(300, avg_degree=4.0, seed=0)
    b = np.random.default_rng(1).normal(size=A.n)
    gv = GLU(A, verify="full")
    rep = gv.verify_report
    assert rep.ok and not rep.skipped, str(rep)
    assert {"audit_factorize", "audit_trisolve"} <= set(rep.checks)
    go = GLU(A)
    new = np.asarray(A.data) * np.random.default_rng(2).uniform(
        0.95, 1.05, size=A.nnz)
    for vals in (None, new):
        xv = gv.factorize(vals).solve(b)
        xo = go.factorize(vals).solve(b)
        assert torch.equal(gv.factorized_values(), go.factorized_values())
        assert xv.tobytes() == xo.tobytes()
    assert gv.solve_info["verify_report"]["skipped"] == {}


def test_graph_audit_flags_eager_dispatch(cuda):
    from repro_torch.analysis import audit_factorize, audit_trisolve

    g = GLU(circuit_jacobian(200, avg_degree=6.0, seed=0), jit_schedule=False)
    assert audit_factorize(g._factorizer).codes == {"AUDIT_DISPATCH"}
    assert audit_trisolve(g._solver).codes == {"AUDIT_DISPATCH"}


def _variant(A, **opts):
    """The matrix's plan, scaled values, and a variant's factorizer with
    replays and its twin with the steps one by one."""
    from repro_torch.core import TorchFactorizer

    g = GLU(A)
    vals = np.asarray(g._A_perm.data)
    f = TorchFactorizer(g.plan, device="cuda", **opts)
    fe = TorchFactorizer(g.plan, device="cuda", jit_schedule=False, **opts)
    return g, vals, f, fe


def test_noflat_k1_run_matches_plain(cuda):
    """With ``disable_modes=("flat",)`` the flat levels join the K1 run, a
    new shape for K1: held bit for bit against its plain version on the
    value array the path hands it."""
    A = circuit_jacobian(200, avg_degree=6.0, seed=0)
    _, vals, _, fe = _variant(A, disable_modes=("flat",))
    assert fe.step_kinds.count("flat") == 0 and "run" in fe.step_kinds
    rec = []
    real = fe._step["run"]

    def record(v, run, *robust):
        rec.append((v.clone(), run))
        return real(v, run, *robust)

    fe._step["run"] = record
    fe.factorize(vals)
    fe._step["run"] = real
    assert rec
    for v0, run in rec:
        _check_run(run, v0)


@pytest.mark.parametrize("opts", [dict(disable_modes=("flat",)),
                                  dict(mode_override="flat")],
                         ids=["noflat", "allflat"])
def test_mode_variant_replays_equal_steps(cuda, opts):
    A = circuit_jacobian(200, avg_degree=6.0, seed=0)
    g, vals, f, fe = _variant(A, **opts)
    rng = np.random.default_rng(5)
    default = GLU(A)
    for _ in range(3):
        new = vals * rng.uniform(0.95, 1.05, size=len(vals))
        got = f.factorize(new).clone()
        want = fe.factorize(new)
        assert torch.equal(got, want)
        ref = default._factorizer.factorize(new)
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)
    assert f.last_n_dispatches == 1


# -- scenario-sharded sweeps on the card ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_sharded_batch_equals_unsharded(cuda, dtype):
    """An emulated 2-shard mesh of the card: every row of a sharded batch
    (B = 6, and B = 5 padded to 6) equals the unsharded batch's bit for
    bit, factors, unrefined and refined solutions, with one factorization
    replay and one solve replay a shard."""
    from repro_torch.distributed import make_sweep_mesh

    cplx = dtype.is_complex
    A = (ac_jacobian if cplx else circuit_jacobian)(300, avg_degree=4.0,
                                                   seed=0)
    rng = np.random.default_rng(3)
    mesh = make_sweep_mesh(devices=[cuda] * 2)
    g = GLU(A, dtype=dtype, mesh=mesh, static_pivot=1e-10)
    g0 = GLU(A, dtype=dtype, static_pivot=1e-10)
    assert g.n_devices == 2 and g.device == torch.device("cuda", 0)
    for B in (6, 5):
        batch = np.asarray(A.data)[None] * (
            1.0 + 0.1 * rng.uniform(-1, 1, size=(B, A.nnz)))
        bs = rng.normal(size=(B, A.n)) + (1j * rng.normal(size=(B, A.n))
                                          if cplx else 0.0)
        for _ in range(2):            # the second call replays
            x = g.refactorize_solve(batch, bs)
            x0 = g0.refactorize_solve(batch, bs)
        assert x.tobytes() == x0.tobytes()
        assert torch.equal(g.factorized_values_batched(),
                           g0.factorized_values_batched())
        info = g.solve_info
        assert info["n_devices"] == 2 and info["n_dispatches"] == 1
        assert info["solve_dispatches"] == 1
        np.testing.assert_array_equal(info["n_perturbed"],
                                      g0.solve_info["n_perturbed"])
        xr = g.solve_batched(bs, refine=2)
        assert xr.tobytes() == g0.solve_batched(bs, refine=2).tobytes()
        np.testing.assert_array_equal(g.solve_info["refine_iters"],
                                      g0.solve_info["refine_iters"])


def test_level_run_refuses_another_devices_run(cuda):
    """A ``LevelRun`` holds device pointers into its own device's layout:
    values on another device are refused before any launch."""
    rng = np.random.default_rng(0)
    run_cpu, vals_cpu = random_level_run(rng, K1_RUNS["one-level"],
                                         torch.float64, "cpu")
    run_gpu, vals_gpu = random_level_run(rng, K1_RUNS["one-level"],
                                         torch.float64, cuda)
    before = level_run.launches
    with pytest.raises(ValueError, match="lie on"):
        level_run(vals_cpu.to(cuda), run_cpu)
    with pytest.raises(ValueError, match="lie on"):
        level_run(vals_gpu.cpu(), run_gpu)
    if torch.cuda.device_count() > 1:
        with pytest.raises(ValueError, match="lie on"):
            level_run(vals_gpu.to("cuda:1"), run_gpu)
    assert level_run.launches == before


def test_sharded_mixed_mesh_moves_rows_between_devices(cuda):
    """A mesh that mixes the card with the CPU (and, on a host of several
    cards, the first and the last card): every row's factors, unrefined
    and refined solutions within 1e-10 / 1e-9 of the unsharded batch on
    the card (the CPU shards run the plain versions), B = 8 and B = 7
    padded to 8, and ``n_perturbed_global`` the padded batch's bump count.
    Each shard's row block, the gathers onto the first device, the exact
    sum and the refinement's lockstep cross devices here."""
    from repro_torch.distributed import make_sweep_mesh

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    A = circuit_jacobian(300, avg_degree=4.0, seed=0)
    rng = np.random.default_rng(4)
    mesh = make_sweep_mesh(devices=[cuda, "cpu", last, "cpu"])
    g = GLU(A, mesh=mesh, static_pivot=1e-10)
    g0 = GLU(A, static_pivot=1e-10)
    assert g.n_devices == 4 and g.device == torch.device("cuda", 0)
    for B in (8, 7):
        batch = np.asarray(A.data)[None] * (
            1.0 + 0.1 * rng.uniform(-1, 1, size=(B, A.nnz)))
        bs = rng.normal(size=(B, A.n))
        for _ in range(2):            # the second call replays
            x = g.refactorize_solve(batch, bs)
            x0 = g0.refactorize_solve(batch, bs)
        assert x.shape == (B, A.n)
        np.testing.assert_allclose(x, x0, rtol=1e-9, atol=1e-9)
        f = g.factorized_values_batched()
        assert f.device == g.device and f.shape[0] == B
        torch.testing.assert_close(f, g0.factorized_values_batched(),
                                   rtol=1e-10, atol=1e-10)
        info = g.solve_info
        assert info["n_devices"] == 4
        assert info["batch_spec"] == "PartitionSpec('data',)"
        n_pert = info["n_perturbed"]
        assert n_pert.shape == (B,) and info["pivot_growth"].shape == (B,)
        np.testing.assert_array_equal(n_pert, g0.solve_info["n_perturbed"])
        assert info["n_perturbed_global"] == int(
            n_pert.sum() + (8 - B) * n_pert[-1])
        xr = g.solve_batched(bs, refine=2)
        np.testing.assert_allclose(xr, g0.solve_batched(bs, refine=2),
                                   rtol=1e-9, atol=1e-9)
        assert g.solve_info["refine_iters"].shape == (B,)


def test_sharded_over_every_card(cuda):
    """A mesh of every card of the host (one card repeated twice where
    there is only one): each shard's graphs are captured and replayed on
    its own card, and every row of a sharded batch (B = 8, and B = 7
    padded to 8) and of a sharded ``transient_sweep`` equals the
    unsharded run on the first card bit for bit."""
    from repro_torch.circuit import rc_grid_circuit, transient_sweep
    from repro_torch.distributed import make_sweep_mesh

    n = torch.cuda.device_count()
    mesh = make_sweep_mesh(devices=[torch.device("cuda", i)
                                    for i in range(n)] * (2 if n == 1 else 1))
    k = len(mesh.devices)
    A = circuit_jacobian(300, avg_degree=4.0, seed=0)
    rng = np.random.default_rng(5)
    g = GLU(A, mesh=mesh)
    g0 = GLU(A, device=mesh.devices[0])
    for B in (8, 7):
        batch = np.asarray(A.data)[None] * (
            1.0 + 0.1 * rng.uniform(-1, 1, size=(B, A.nnz)))
        bs = rng.normal(size=(B, A.n))
        for _ in range(2):            # the second call replays
            x = g.refactorize_solve(batch, bs)
            x0 = g0.refactorize_solve(batch, bs)
        assert x.tobytes() == x0.tobytes()
        assert torch.equal(g.factorized_values_batched(),
                           g0.factorized_values_batched())
        info = g.solve_info
        assert info["n_devices"] == k and info["n_dispatches"] == 1
        assert info["solve_dispatches"] == 1
        xr = g.solve_batched(bs, refine=2)
        assert xr.tobytes() == g0.solve_batched(bs, refine=2).tobytes()
    ckt = rc_grid_circuit(8, 8, with_diodes=True, seed=0)
    kw = dict(t_end=0.02, dt=5e-3, refine=1, scales=np.linspace(0.9, 1.1, 4))
    got = transient_sweep(ckt, mesh=mesh, **kw)
    want = transient_sweep(ckt, device=mesh.devices[0], **kw)
    assert got.n_devices == k
    assert got.voltages.tobytes() == want.voltages.tobytes()


# -- the LM serving path (chip_smoke.py phase 17 (b) and (d)) ----------------

@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def test_lm_float32_prefill_decode_match_train(cuda, no_tf32):
    """qwen2.5-3b at full width, cut to 4 layers, in float32 with TF32
    off: a prefill and two decode steps within 3e-4 of the full-sequence
    pass at the same positions (the reference's own bar), same argmax."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import (forward_decode, forward_prefill,
                                    forward_train, init_params)

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4,
                              dtype="float32")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    full, _ = forward_train(model, tokens, cfg)
    logits, cache = forward_prefill(model, tokens[:, :38], cfg, max_len=40)
    steps = [logits]
    for t in (38, 39):
        logits, cache = forward_decode(model, tokens[:, t:t + 1], cache, cfg)
        steps.append(logits)
    steps = torch.stack(steps, 1)
    want = full[:, 37:]
    assert (steps - want).abs().max().item() < 3e-4
    assert torch.equal(steps.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi-3-vision-4.2b",
                                  "whisper-base", "deepseek-v2-lite-16b",
                                  "mixtral-8x7b", "mamba2-2.7b",
                                  "jamba-v0.1-52b"])
def test_lm_card_matches_cpu(cuda, no_tf32, arch):
    """The reduced config with the same float32 parameters on the card and
    on the CPU: logits within 1e-4 and the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays
    from repro_torch.models import forward_train, init_params
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch).reduced()
    host = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = lm_params_from_arrays(cfg, lm_params_to_arrays(host), device=cuda)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    extras = None
    if cfg.frontend == "audio_stub":
        extras = {"frames": rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)
                                       ).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        extras = {"patch_embeds": rng.normal(
            size=(2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    want, _ = forward_train(host, tokens, cfg, extras)
    got, _ = forward_train(card, tokens, cfg, extras)
    assert (got.cpu() - want).abs().max().item() < 1e-4
    out_h = ServeEngine(cfg, host, extras, device="cpu").generate_batch(tokens[:, :16], 8)
    out_c = ServeEngine(cfg, card, extras, device=cuda).generate_batch(tokens[:, :16], 8)
    np.testing.assert_array_equal(out_c, out_h)


def test_lm_serve_bf16_repeats(cuda):
    """bfloat16 generation on the card: the same tokens twice, and an
    engine refuses a model that lies on another device."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    engine = ServeEngine(cfg, model)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 12))
    np.testing.assert_array_equal(engine.generate_batch(prompts, 6),
                                  engine.generate_batch(prompts, 6))
    with pytest.raises(ValueError, match="lies on"):
        ServeEngine(cfg, model, device="cpu")


@pytest.mark.parametrize("length", [2, 256])
def test_mamba2_block_card_matches_cpu(cuda, no_tf32, length):
    """The Mamba-2 block at jamba's full width with the same float32
    weights on the card and on the CPU: a causal pass (2 positions, then
    two chunks of 128) and three decode steps, outputs and the state and
    conv caches within 1e-4; the caches stay where they were allocated."""
    from repro_torch.configs import get_config
    from repro_torch.models import cache_specs
    from repro_torch.models.layers import Mamba2

    cfg = get_config("jamba-v0.1-52b")
    gen = torch.Generator().manual_seed(0)
    host = Mamba2(cfg, "cpu")
    with torch.no_grad():
        for name, w in host.named_parameters():
            w.copy_(torch.randn(w.shape, generator=gen) * 0.02
                    + (1.0 if name.endswith("scale") else 0.0))
    host = host.float()
    card = Mamba2(cfg, cuda).float()
    card.load_state_dict(host.state_dict())
    x = torch.randn(2, length + 3, cfg.d_model, generator=gen)
    spec = cache_specs(cfg, 2, 1)["layers"][0]
    caches = [{k: torch.zeros(shape, device=dev) for k, (shape, _) in spec.items()}
              for dev in ("cpu", cuda)]
    outs = []
    with torch.no_grad():
        for block, cache in zip((host, card), caches):
            xd = x.to(cache["h"].device)
            h = cache["h"]
            ys = [block(xd[:, :length], cache=cache)]
            for t in range(length, length + 3):
                ys.append(block(xd[:, t:t + 1], mode="decode", cache=cache))
            assert cache["h"] is h
            outs.append(torch.cat(ys, 1).cpu())
    assert (outs[0] - outs[1]).abs().max().item() < 1e-4
    for k in spec:
        assert (caches[0][k] - caches[1][k].cpu()).abs().max().item() < 1e-4, k


# -- the training path (chip_smoke.py phase 20) --------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b", "mamba2-2.7b"])
def test_train_grads_card_matches_cpu(cuda, no_tf32, arch):
    """The reduced config (remat on) with the same float32 parameters on
    the card and on the CPU: the loss within 1e-5 and every gradient leaf
    within 1e-4 of its largest entry (or of a millionth of the model's
    largest, where a leaf's gradients cancel to float32 noise: chip_smoke
    phase 20 (b)), over two chunks of the Mamba-2 scan."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import TrainConfig, grads_of

    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    host = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = lm_params_from_arrays(cfg, lm_params_to_arrays(host), device=cuda)
    batch = TokenPipeline(cfg.padded_vocab, 2, 256, seed=3).batch_at(0)
    (g_h, l_h, _), (g_c, l_c, _) = (
        grads_of(m.requires_grad_(True), batch, cfg, TrainConfig())
        for m in (host, card))
    assert abs(l_h.item() - l_c.item()) < 1e-5
    top = max(g.abs().max() for g in g_h.values())
    for n, g in g_h.items():
        assert (g_c[n].cpu() - g).abs().max() <= 1e-4 * max(g.abs().max(), 1e-6 * top), n


def test_train_steps_repeat_bit_for_bit_on_card(cuda):
    """Two runs of three bf16 AdamW steps from the same init (remat on):
    the same losses and parameters bit for bit, which a resumed run
    relies on (the embedding's backward sums repeated tokens in a fixed
    order)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, init_opt_state, make_train_step

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), dtype="bfloat16",
                              remat=True)
    opt_cfg = OptConfig(lr=1e-3, warmup=1, total_steps=10)
    pipe = TokenPipeline(cfg.padded_vocab, 4, 64, seed=0)
    runs = []
    for _ in range(2):
        model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda).requires_grad_(True)
        opt = init_opt_state(model, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        losses = [step(model, opt, pipe.batch_at(i))[2]["loss"].item() for i in range(3)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_train_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A bf16 model's training state written from the card and restored
    onto it: the same dtypes and bits, the moments taken as restored."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import load_train_state, train_state
    from repro_torch.models import LM, init_params
    from repro_torch.train import OptConfig, init_opt_state, restore_checkpoint, \
        save_checkpoint

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), num_layers=8,
                              dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    opt_cfg = OptConfig()
    opt = init_opt_state(model, opt_cfg)
    for v in opt["m"].values():
        v.normal_()
    save_checkpoint(tmp_path, 1, train_state(model, opt))
    fresh = LM(cfg, cuda)
    opt2 = load_train_state(fresh, opt_cfg, restore_checkpoint(tmp_path, 1, device=cuda),
                            cuda)
    for (n, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    for path, v in opt["m"].items():
        assert opt2["m"][path].device.type == "cuda"
        assert torch.equal(opt2["m"][path], v), path


def test_train_launcher_on_card(cuda, tmp_path, capsys):
    """The launcher on the card (its default device): 4 steps with a
    checkpoint, then a call with 6 steps resumes from step 4."""
    from repro_torch.launch import train as launch_train

    args = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "4", "--seq", "32",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    first = launch_train.main(args + ["--steps", "4"])
    second = launch_train.main(args + ["--steps", "6"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert [r["step"] for r in first + second] == list(range(6))
    assert all(np.isfinite(r["loss"]) for r in first + second)
