"""PyTorch port, Matrix Market I/O and ``multi_domain_circuit`` on the CPU.

``repro_torch.sparse.read_matrix_market`` against the JAX package's on the
same files (general, gzip-compressed, symmetric, pattern; a non-square one
refused by both), a write/read round trip, and ``multi_domain_circuit``
against the reference's.  Every comparison is exact: the same CSC arrays,
byte for byte, with the same dtypes (values are written with ``%.17g``,
which round-trips a float64).
"""
import gzip

import numpy as np
import pytest

import repro.sparse as jsparse
import repro_torch.sparse as tsparse


def _same_csc(a, b):
    assert a.n == b.n
    for k in ("indptr", "indices", "data"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype, k
        assert x.tobytes() == y.tobytes(), k


GENERAL = """%%MatrixMarket matrix coordinate real general
% a comment line
4 4 7
1 1 4.0
2 1 -1.5
2 2 3.25
3 3 2.0
4 3 -0.125
4 4 5.0
1 4 1e-3
"""
SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
3 3 5
1 1 2.0
2 1 -1.0
2 2 2.0
3 2 -1.0
3 3 2.0
"""
PATTERN = """%%MatrixMarket matrix coordinate pattern general
3 3 4
1 1
2 2
3 1
3 3
"""
NONSQUARE = """%%MatrixMarket matrix coordinate real general
2 3 2
1 1 1.0
2 3 1.0
"""
FILES = {"general.mtx": GENERAL, "general.mtx.gz": GENERAL,
         "symmetric.mtx": SYMMETRIC, "pattern.mtx": PATTERN}


def _write(path, text):
    if path.suffix == ".gz":
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)


@pytest.mark.parametrize("name", list(FILES))
def test_read_matches_reference(tmp_path, name):
    path = tmp_path / name
    _write(path, FILES[name])
    got = tsparse.read_matrix_market(path)
    _same_csc(got, jsparse.read_matrix_market(path))
    if name.startswith("symmetric"):
        dense = got.to_scipy().toarray()
        assert np.array_equal(dense, dense.T)
    if name.startswith("pattern"):
        assert np.all(np.asarray(got.data) == 1.0)


def test_non_square_refused(tmp_path):
    path = tmp_path / "rect.mtx"
    path.write_text(NONSQUARE)
    with pytest.raises(ValueError, match="square"):
        tsparse.read_matrix_market(path)
    with pytest.raises(ValueError, match="square"):
        jsparse.read_matrix_market(path)


def test_not_matrix_market_refused(tmp_path):
    path = tmp_path / "x.mtx"
    path.write_text("hello\n1 1 1\n")
    with pytest.raises(ValueError, match="MatrixMarket"):
        tsparse.read_matrix_market(path)


@pytest.mark.parametrize("gen,kw", [
    ("grid_laplacian", dict(nx=12, ny=9, seed=3)),
    ("circuit_jacobian", dict(n=150, avg_degree=5.0, seed=2)),
], ids=["grid", "circuit"])
def test_write_read_round_trip(tmp_path, gen, kw):
    A = getattr(tsparse, gen)(**kw)
    path = tmp_path / "a.mtx"
    tsparse.write_matrix_market(path, A)
    _same_csc(tsparse.read_matrix_market(path), A)
    # the reference reads the port's file to the same arrays, and writes
    # the same bytes
    _same_csc(jsparse.read_matrix_market(path), A)
    jpath = tmp_path / "j.mtx"
    jsparse.write_matrix_market(jpath, getattr(jsparse, gen)(**kw))
    assert jpath.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("kw", [dict(), dict(domain_sizes=(100, 64, 49),
                                             seed=5)],
                         ids=["default", "small"])
def test_multi_domain_circuit_matches_reference(kw):
    got = tsparse.multi_domain_circuit(**kw)
    _same_csc(got, jsparse.multi_domain_circuit(**kw))
    if not kw:
        assert got.n == 6400


def test_multi_domain_blocks_are_decoupled():
    """No entry couples two domains: the matrix is block diagonal."""
    sizes = (36, 25, 16)
    A = tsparse.multi_domain_circuit(sizes, seed=1)
    rows, cols, _ = A.to_coo()
    edges = np.cumsum((0,) + sizes)
    dom = np.searchsorted(edges, np.arange(A.n), side="right") - 1
    assert np.array_equal(dom[rows], dom[cols])
