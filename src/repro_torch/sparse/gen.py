"""Synthetic circuit-matrix generators.

The paper benchmarks on UFL/SuiteSparse circuit matrices (rajat*, ASIC_*,
G3_circuit, ...).  Those files are not available offline, so we generate
matrices with the same structural character:

* near-structurally-symmetric pattern (MNA stamps are symmetric; sources and
  controlled elements break numeric symmetry),
* zero-free, dominant diagonal (conductance stamps),
* low average degree (2-8 nonzeros/column) with a few high-degree
  rows/columns (supply rails, clock nets),
* large, irregular level structure after fill-in.

The same seed gives the same bytes as the JAX package's generators.
"""
from __future__ import annotations

import numpy as np

from .csc import CSC, csc_from_coo

__all__ = [
    "grid_laplacian",
    "rc_ladder",
    "circuit_jacobian",
    "asic_like",
    "SUITES",
    "make_suite_matrix",
]


def grid_laplacian(nx: int, ny: int, leak: float = 1e-3, seed: int = 0) -> CSC:
    """2-D resistor-grid conductance matrix (G3_circuit-like).

    Structurally symmetric, diagonally dominant, n = nx*ny.
    """
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


def rc_ladder(n: int, seed: int = 0) -> CSC:
    """RC ladder network conductance matrix (tridiagonal, memplus-flavoured)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 2.0, size=n - 1)
    rows, cols, vals = [], [], []
    for i in range(n - 1):
        rows.extend([i, i + 1, i, i + 1])
        cols.extend([i, i + 1, i + 1, i])
        vals.extend([g[i], g[i], -g[i], -g[i]])
    rows.extend(range(n))
    cols.extend(range(n))
    vals.extend(np.full(n, 1e-2))
    return csc_from_coo(n, rows, cols, vals)


def circuit_jacobian(
    n: int,
    avg_degree: float = 4.0,
    n_rails: int = 0,
    rail_fanout: int = 64,
    asym: float = 0.1,
    pattern_asym: float = 0.0,
    seed: int = 0,
) -> CSC:
    """Random circuit-Jacobian-like matrix (rajat*-flavoured).

    Mostly symmetric pattern with ``asym`` fraction of value asymmetry,
    ``pattern_asym`` fraction of structurally one-sided entries (controlled
    sources / transistor stamps), and ``n_rails`` high-degree nodes.
    Diagonally dominant so no-pivot LU is numerically safe (the GLU flow
    relies on MC64+AMD for this on real data).
    """
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    a = rng.integers(0, n, size=m)
    b = rng.integers(0, n, size=m)
    keep = a != b
    a, b = a[keep], b[keep]
    g = rng.uniform(0.1, 1.0, size=len(a))
    if pattern_asym > 0:
        one_sided = rng.uniform(size=len(a)) < pattern_asym
    else:
        one_sided = np.zeros(len(a), dtype=bool)
    two = ~one_sided
    rows = [a, b[two]]
    cols = [b, a[two]]
    vals = [-g, -g[two] * (1.0 - asym * rng.uniform(0, 1, size=two.sum()))]
    # high-degree rail nodes
    for r in range(n_rails):
        node = rng.integers(0, n)
        targets = rng.choice(n, size=min(rail_fanout, n - 1), replace=False)
        targets = targets[targets != node]
        gr = rng.uniform(0.1, 1.0, size=len(targets))
        rows.extend([np.full(len(targets), node), targets])
        cols.extend([targets, np.full(len(targets), node)])
        vals.extend([-gr, -gr])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    # diagonal = row-sum dominance + leak
    diag = np.full(n, 0.5)
    np.add.at(diag, rows, np.abs(vals))
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, diag])
    return csc_from_coo(n, rows, cols, vals)


def asic_like(n: int, seed: int = 0) -> CSC:
    """ASIC_100ks-flavoured: grid backbone + random long-range couplings."""
    side = max(2, int(np.sqrt(n)))
    base = grid_laplacian(side, side, seed=seed)
    nn = base.n
    rng = np.random.default_rng(seed + 1)
    extra = max(nn // 10, 4)
    a = rng.integers(0, nn, size=extra)
    b = rng.integers(0, nn, size=extra)
    keep = a != b
    a, b = a[keep], b[keep]
    g = rng.uniform(0.05, 0.5, size=len(a))
    r0, c0, v0 = base.to_coo()
    rows = np.concatenate([r0, a, b, a, b])
    cols = np.concatenate([c0, b, a, a, b])
    vals = np.concatenate([v0, -g, -g, g + 0.25, g + 0.25])
    return csc_from_coo(nn, rows, cols, vals)


# Named suite mirroring the paper's Table I matrix list (synthetic stand-ins).
# sizes are scaled down so CPU-hosted benchmarks finish; pass scale>1 to grow.
SUITES = {
    "rajat12_like": ("circuit_jacobian", dict(n=1879, avg_degree=6.9)),
    "circuit_2_like": ("circuit_jacobian", dict(n=4510, avg_degree=4.7, n_rails=4)),
    "memplus_like": ("rc_ladder", dict(n=17758)),
    "rajat27_like": ("circuit_jacobian", dict(n=20640, avg_degree=4.8, n_rails=8)),
    "onetone2_like": ("circuit_jacobian", dict(n=36057 // 4, avg_degree=6.3, n_rails=16, asym=0.4)),
    "grid64": ("grid_laplacian", dict(nx=64, ny=64)),
    "grid128": ("grid_laplacian", dict(nx=128, ny=128)),
    "asic_like_10k": ("asic_like", dict(n=10000)),
}


def make_suite_matrix(name: str, scale: float = 1.0, seed: int = 0) -> CSC:
    kind, kwargs = SUITES[name]
    kwargs = dict(kwargs)
    for key in ("n", "nx", "ny"):
        if key in kwargs:
            kwargs[key] = max(4, int(kwargs[key] * scale))
    kwargs["seed"] = seed
    return {
        "circuit_jacobian": circuit_jacobian,
        "grid_laplacian": grid_laplacian,
        "rc_ladder": rc_ladder,
        "asic_like": asic_like,
    }[kind](**kwargs)
