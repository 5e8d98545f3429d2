"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and the GLU facade end to end.  Every test
needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere; run them there
with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import GLU
from repro_torch.kernels import dense_lu, dense_lu_planar, segmented_accumulate
from repro_torch.kernels.ref import (
    dense_lu_planar_ref,
    dense_lu_ref,
    lu_backward_error,
    segmented_accumulate_ref,
)
from repro_torch.sparse import ac_jacobian, circuit_jacobian

pytestmark = pytest.mark.cuda

K1_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
K2_TOL = {torch.float32: 5e-3, torch.float64: 1e-9}


@pytest.fixture
def cuda():
    # decided here, never at import: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _k1_inputs(D, R, C, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    cv = torch.from_numpy(rng.normal(size=(D, C))).to(device, dtype)
    cb = torch.from_numpy(rng.normal(size=(D, R))).to(device, dtype)
    dl = torch.from_numpy(rng.integers(0, C + 64, size=(D, R)).astype(np.int32))
    return cv, cb, dl.to(device)


@pytest.mark.parametrize("D,R,C", [(905, 90, 297), (905, 256, 384), (4, 384, 256),
                                   (3, 768, 1024), (2, 256, 2048),
                                   (728, 1280, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_matches_plain(cuda, D, R, C, dtype):
    cv, cb, dl = _k1_inputs(D, R, C, dtype, cuda)
    before = segmented_accumulate.launches
    got = segmented_accumulate(cv, cb, dl)
    torch.cuda.synchronize()
    assert segmented_accumulate.launches == before + 1
    want = segmented_accumulate_ref(cv, cb, dl)
    tol = K1_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_k1_duplicates_and_determinism(cuda):
    D, R, C = 64, 1024, 128
    rng = np.random.default_rng(3)
    cv = torch.zeros((D, C), dtype=torch.float64, device=cuda)
    cb = torch.from_numpy(rng.normal(size=(D, R))).to(cuda)
    dl = torch.from_numpy(rng.integers(0, 4, size=(D, R)).astype(np.int32)).to(cuda)
    a = segmented_accumulate(cv, cb, dl)
    b = segmented_accumulate(cv, cb, dl)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, segmented_accumulate_ref(cv, cb, dl),
                               rtol=1e-12, atol=1e-12)
    ones = segmented_accumulate(cv, torch.ones_like(cb), torch.zeros_like(dl))
    assert torch.all(ones[:, 0] == R) and torch.all(ones[:, 1:] == 0)


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
    cv = torch.zeros((2, 128), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        segmented_accumulate(cv, cv, torch.zeros((2, 128), dtype=torch.int64,
                                                 device=cuda))
    with pytest.raises(ValueError):
        segmented_accumulate(cv, cv.t().contiguous().t()[:, :64],
                             torch.zeros((2, 64), dtype=torch.int32, device=cuda))
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
    k1, k2 = segmented_accumulate.launches, dense_lu.launches
    g = GLU(A)
    x = g.factorize().solve(b, refine=2)
    kinds = g._factorizer.kinds
    assert segmented_accumulate.launches - k1 == kinds.count("pallas") > 0
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
    k1, k2, k3 = (segmented_accumulate.launches, dense_lu.launches,
                  dense_lu_planar.launches)
    g = GLU(A, dtype=torch.complex128)
    x = g.factorize().solve(b, refine=2)
    kinds = g._factorizer.kinds
    assert segmented_accumulate.launches - k1 == kinds.count("pallas") > 0
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
