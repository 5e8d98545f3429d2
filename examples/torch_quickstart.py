"""Quickstart on the PyTorch port: factorize a circuit matrix with GLU3.0
and solve Ax = b, then refactorize new values on the same pattern.  Runs
on the card; ``--device cpu`` runs the kernels' plain versions on the
host.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import GLU
from repro_torch.sparse import circuit_jacobian


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2000, help="matrix order")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # a circuit-style sparse matrix (structurally symmetric-ish, diagonally
    # dominant: what MNA assembly produces)
    A = circuit_jacobian(args.n, avg_degree=4.0, seed=0)
    b = np.random.default_rng(0).normal(size=A.n)

    # plan once: MC64 -> fill-reducing ordering -> symbolic fill-in ->
    # relaxed dependency detection (paper Alg. 4) -> levelization -> plan
    solver = GLU(A, dtype=torch.float64, device=args.device)
    print(f"n={A.n}  nnz(A)={A.nnz}  nnz(L+U)={solver.nnz_filled}  "
          f"levels={solver.num_levels}  device={solver.device}")

    # numeric factorization on the device (level-parallel: flat steps, K1
    # runs, the dense tail on K2)
    solver.factorize()
    x = solver.solve(b)
    residuals = [solver.residual(b, x)]
    solutions = [x]
    print(f"residual ||Ax-b||_inf / ||b||_inf = {residuals[0]:.2e}")

    # the SPICE pattern: refactorize new values on the same pattern, no
    # symbolic work: the loop GLU3.0 accelerates
    for it in range(3):
        scale = 1.0 + 0.1 * it
        solver.factorize(np.asarray(A.data) * scale)
        x = solver.solve(b)
        res = float(np.abs(A.to_scipy() @ (x * scale) - b).max())
        print(f"refactorization {it}: residual scale-invariant check "
              f"{res:.2e}")
        solutions.append(x)
        residuals.append(res)
    assert all(np.isfinite(s).all() for s in solutions)
    return dict(solutions=np.stack(solutions), residuals=residuals,
                n=A.n, nnz_filled=solver.nnz_filled,
                levels=solver.num_levels)


if __name__ == "__main__":
    main()
