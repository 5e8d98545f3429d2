"""The capacitance matrix C of an AC small-signal system ``G + jwC`` on G's
pattern: frozen copy of the C half of ``repro_torch.sparse.gen.ac_jacobian``
(ground capacitors on every diagonal, a ``cap_coupling`` share of the
off-diagonal entries coupled with MNA's signs).  ``seed`` is the seed G was
built with."""
import numpy as np

from portbench.matrix import Matrix


def build(G: Matrix, cap_coupling: float = 0.25, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 3)
    c = np.zeros(G.nnz)
    off = ~G.diag_mask()
    pick = off & (rng.uniform(size=G.nnz) < cap_coupling)
    c[pick] = -rng.uniform(1e-4, 1e-3, size=int(pick.sum()))
    diag = np.zeros(G.n)
    np.add.at(diag, G.indices[pick], -c[pick])
    c[np.flatnonzero(G.diag_mask())] = diag + rng.uniform(1e-4, 1e-3, size=G.n)
    return c
