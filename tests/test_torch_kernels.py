"""PyTorch port, kernels: the plain PyTorch versions of K1 and K2 against
the JAX package's Pallas kernels in interpret mode, on the shape and dtype
sweep of tests/test_kernels.py.  On CPU tensors the kernel wrappers run
these plain versions; the CUDA kernels themselves are held against them on
the card in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import dense_lu as jax_dense_lu
from repro.kernels import segmented_accumulate as jax_segmented_accumulate
from repro_torch.kernels import dense_lu, segmented_accumulate
from repro_torch.kernels.ops import (
    add_in_rounds_,
    factor_stats,
    masked_correction,
    round_order,
    spmv,
)
from repro_torch.kernels.ref import (
    dense_lu_ref,
    lu_backward_error,
    segmented_accumulate_ref,
)

# stated tolerances: K1 sums the same terms (f64 1e-12, f32 1e-5); K2 is
# unblocked here and blocked in the reference (f64 1e-9, f32 5e-3)
K1_TOL = {np.float32: 1e-5, np.float64: 1e-12}
K2_TOL = {np.float32: 5e-3, np.float64: 1e-9}


@pytest.mark.parametrize("D,C,R", [
    (1, 128, 256),
    (4, 384, 256),
    (8, 512, 512),
    (3, 1024, 768),
    (2, 2048, 256),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segmented_accumulate_matches_pallas(D, C, R, dtype, rng):
    cv = rng.normal(size=(D, C)).astype(dtype)
    cb = rng.normal(size=(D, R)).astype(dtype)
    dl = rng.integers(0, C + 64, size=(D, R)).astype(np.int32)  # some padded
    cb = np.where(dl < C, cb, 0.0).astype(dtype)
    want = np.asarray(jax_segmented_accumulate(
        jnp.asarray(cv), jnp.asarray(cb), jnp.asarray(dl), interpret=True))
    got = segmented_accumulate_ref(torch.from_numpy(cv), torch.from_numpy(cb),
                                   torch.from_numpy(dl)).numpy()
    assert got.dtype == dtype and got.shape == (D, C)
    np.testing.assert_allclose(got, want, rtol=K1_TOL[dtype], atol=K1_TOL[dtype])
    # the wrapper runs the plain version for CPU tensors
    wrapped = segmented_accumulate(torch.from_numpy(cv), torch.from_numpy(cb),
                                   torch.from_numpy(dl)).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_segmented_accumulate_duplicate_indices():
    """Many updates hitting the same slot must sum (the GPU-atomics case)."""
    D, C, R = 2, 128, 512
    cv = np.zeros((D, C), np.float64)
    cb = np.ones((D, R))
    dl = np.zeros((D, R), np.int32)  # all hit slot 0
    want = np.asarray(jax_segmented_accumulate(
        jnp.asarray(cv), jnp.asarray(cb), jnp.asarray(dl), interpret=True))
    got = segmented_accumulate(torch.from_numpy(cv), torch.from_numpy(cb),
                               torch.from_numpy(dl)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[:, 0] == R) and np.all(got[:, 1:] == 0.0)


def test_segmented_accumulate_drops_padding_values():
    """Dropped positions are never read: NaN contributions at padded or
    negative positions leave the result untouched."""
    cv = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    cb = torch.tensor([[1.0, float("nan"), 2.0], [float("nan"), 4.0, 8.0]],
                      dtype=torch.float64)
    dl = torch.tensor([[0, 3, 0], [-1, 2, 2]], dtype=torch.int32)
    out = segmented_accumulate(cv, cb, dl)
    torch.testing.assert_close(out, torch.tensor([[3.0, 1.0, 2.0],
                                                  [3.0, 4.0, 17.0]],
                                                 dtype=torch.float64))


@pytest.mark.parametrize("N,block", [(128, 128), (256, 128), (256, 64), (384, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dense_lu_matches_pallas(N, block, dtype, rng):
    a = (rng.normal(size=(N, N)) + N * np.eye(N)).astype(dtype)
    want = np.asarray(jax_dense_lu(jnp.asarray(a), block=block, interpret=True))
    got = dense_lu(torch.from_numpy(a)).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=K2_TOL[dtype], atol=K2_TOL[dtype])
    L = np.tril(got.astype(np.float64), -1) + np.eye(N)
    U = np.triu(got.astype(np.float64))
    lu_tol = 1e-2 if dtype == np.float32 else 1e-8
    np.testing.assert_allclose(L @ U, a.astype(np.float64), rtol=lu_tol, atol=lu_tol)


def test_dense_lu_ref_does_not_modify_input(rng):
    a = torch.from_numpy(rng.normal(size=(64, 64)) + 64 * np.eye(64))
    before = a.clone()
    dense_lu_ref(a)
    assert torch.equal(a, before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_lu_ref_backward_error(dtype, rng):
    """The L factor is held to its reconstruction, not only to an absolute
    tolerance its entries (about 1/N here) lie below: a zero or scaled L
    fails the check."""
    N = 160
    a = torch.from_numpy(rng.normal(size=(N, N)) + N * np.eye(N)).to(dtype)
    lu = dense_lu(a)
    assert lu_backward_error(a, lu) <= 4.0 * N * torch.finfo(dtype).eps
    assert lu_backward_error(a, torch.triu(lu)) > 1.0
    bad = lu.clone()
    bad[1:, 0] *= 1.01
    assert lu_backward_error(a, bad) > 1e-3


def test_flat_level_step_is_sequential(rng):
    """One flat level of the executor (normalise, then the MAC updates in
    round order) gives the bits of a sequential loop, duplicates included."""
    from repro_torch.core.factorize import _level_step

    nnz = 12
    vals = rng.normal(size=nnz) + 3.0
    norm_idx, norm_diag = np.array([4, 5, 6]), np.array([2, 2, 3])
    lidx = np.array([4, 5, 6, 4, 6])
    uidx = np.array([1, 1, 0, 8, 9])
    didx = np.array([7, 7, 10, 11, 7])
    want = vals.copy()
    want[norm_idx] = want[norm_idx] / want[norm_diag]
    for l, u, d in zip(lidx, uidx, didx):
        want[d] -= want[l] * want[u]
    perm, bounds = round_order(didx)
    got = torch.from_numpy(vals.copy())
    t = torch.from_numpy
    _level_step(got, t(norm_idx), t(norm_diag), t(lidx[perm]), t(uidx[perm]),
                t(didx[perm]), bounds)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spmv_matches_scipy(rng):
    from repro_torch.sparse import circuit_jacobian

    A = circuit_jacobian(300, avg_degree=4.0, seed=3)
    S = A.to_scipy().tocsr()
    x = rng.normal(size=A.n)
    row_ids = np.repeat(np.arange(A.n), np.diff(S.indptr))
    y = spmv(torch.from_numpy(row_ids), torch.from_numpy(S.indices.astype(np.int64)),
             torch.from_numpy(S.data), torch.from_numpy(x), A.n).numpy()
    np.testing.assert_allclose(y, S @ x, rtol=1e-10)


def test_factor_stats_and_masked_correction():
    vals = torch.tensor([4.0, -8.0, 0.5, 2.0], dtype=torch.float64)
    growth, min_diag = factor_stats(vals, torch.tensor([0, 2]),
                                    torch.tensor(2.0, dtype=torch.float64))
    assert growth.item() == 4.0 and min_diag.item() == 0.5
    x = torch.ones(3, dtype=torch.float64)
    d = torch.full((3,), 0.5, dtype=torch.float64)
    assert torch.equal(masked_correction(x, d, torch.tensor(1e-3), 1e-6), x + d)
    assert torch.equal(masked_correction(x, d, torch.tensor(1e-9), 1e-6), x)


@pytest.mark.parametrize("which", ["k1", "k2"])
def test_wrappers_refuse_other_devices(which):
    """A tensor that lies neither on the CPU nor on the card raises: the
    wrappers never fall back to the plain version on their own."""
    if which == "k1":
        t = torch.empty((2, 128), dtype=torch.float64, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            segmented_accumulate(t, t, torch.empty((2, 128), dtype=torch.int32,
                                                   device="meta"))
    else:
        with pytest.raises(ValueError, match="cuda or cpu"):
            dense_lu(torch.empty((64, 64), dtype=torch.float64, device="meta"))


@pytest.mark.parametrize("n,targets", [(0, 5), (1, 5), (40, 3), (300, 50), (64, 1)])
def test_round_order_scatter_is_sequential(n, targets, rng):
    """Rounds of distinct targets reproduce a sequential scatter-add bit for
    bit: each target meets its entries in their original order."""
    idx = rng.integers(0, targets, size=n)
    src = rng.normal(size=n)
    perm, bounds = round_order(idx)
    assert sorted(perm.tolist()) == list(range(n)) and bounds[-1] == n
    for s, e in zip(bounds[:-1], bounds[1:]):
        assert len(set(idx[perm[s:e]].tolist())) == e - s
    want = np.full(targets, 0.25)
    for i, v in zip(idx, src):
        want[i] -= v
    got = add_in_rounds_(torch.full((targets,), 0.25, dtype=torch.float64),
                         torch.from_numpy(idx[perm]), torch.from_numpy(src[perm]),
                         bounds, alpha=-1.0)
    np.testing.assert_array_equal(got.numpy(), want)
