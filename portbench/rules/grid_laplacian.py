"""2-D resistor power grid, the structure of UFL's G2/G3_circuit: frozen
copy of ``repro_torch.sparse.gen.grid_laplacian``."""
import numpy as np

from portbench.matrix import Matrix, csc_from_coo


def build(nx: int, ny: int, leak: float = 1e-3, seed: int = 0) -> Matrix:
    rng = np.random.default_rng(seed)
    n = nx * ny
    idx = np.arange(n).reshape(ny, nx)
    rows, cols, vals = [], [], []

    def stamp(a, b, g):
        rows.extend([a, b, a, b])
        cols.extend([a, b, b, a])
        vals.extend([g, g, -g, -g])

    gh = rng.uniform(0.5, 2.0, size=(ny, nx - 1))
    gv = rng.uniform(0.5, 2.0, size=(ny - 1, nx))
    for y in range(ny):
        for x in range(nx - 1):
            stamp(idx[y, x], idx[y, x + 1], gh[y, x])
    for y in range(ny - 1):
        for x in range(nx):
            stamp(idx[y, x], idx[y + 1, x], gv[y, x])
    rows.extend(range(n))
    cols.extend(range(n))
    vals.extend(np.full(n, leak))  # ground leak keeps it non-singular
    return csc_from_coo(n, rows, cols, vals)
