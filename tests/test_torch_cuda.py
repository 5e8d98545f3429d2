"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and the GLU facade end to end.  Every test
needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere; run them there
with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import GLU
from repro_torch.kernels import dense_lu, segmented_accumulate
from repro_torch.kernels.ref import (
    dense_lu_ref,
    lu_backward_error,
    segmented_accumulate_ref,
)
from repro_torch.sparse import circuit_jacobian

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


@pytest.mark.parametrize("N", [128, 160, 256, 736, 768, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_matches_plain(cuda, N, dtype):
    rng = np.random.default_rng(N)
    a = torch.from_numpy(rng.normal(size=(N, N)) + N * np.eye(N)).to(cuda, dtype)
    before = dense_lu.launches
    got = dense_lu(a)
    torch.cuda.synchronize()
    assert dense_lu.launches == before + 1
    want = dense_lu_ref(a)
    tol = K2_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # L's entries (about 1/N) lie below the f32 tolerance: hold L to the
    # reconstruction too
    assert lu_backward_error(a, got) <= 4.0 * N * torch.finfo(dtype).eps
    assert torch.equal(dense_lu(a), got)


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
