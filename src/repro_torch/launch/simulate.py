"""Circuit-simulation command line: the paper's end-to-end application.

  PYTHONPATH=src python -m repro_torch.launch.simulate --nx 8 --ny 8 \\
      --t-end 0.05 --dt 0.005

Runs :func:`~repro_torch.circuit.transient` on an RC grid and prints the
JAX package's two lines.  ``--device`` defaults to the card (``cpu`` runs
the kernels' plain PyTorch versions).  ``--pallas`` is accepted and does
nothing: the hand-written kernels are the default on the card.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..circuit import rc_grid_circuit, transient
from ..configs import CONFIG


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--ny", type=int, default=8)
    ap.add_argument("--t-end", type=float, default=0.05)
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--no-diodes", action="store_true")
    ap.add_argument("--ordering", default=CONFIG.ordering)
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the JAX package's command lines; "
                         "no effect")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=CONFIG.device,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    ckt = rc_grid_circuit(args.nx, args.ny, with_diodes=not args.no_diodes,
                          seed=args.seed)
    res = transient(ckt, args.t_end, args.dt, ordering=args.ordering,
                    device=args.device)
    print(f"nodes: {args.nx * args.ny}  steps: {len(res.times)}  "
          f"newton: {res.newton_iters.sum()}  factorizations: {res.n_factorizations}")
    print(f"setup {res.setup_seconds:.2f}s  solve {res.solve_seconds:.2f}s  "
          f"max residual {res.max_residual:.2e}")
    assert np.isfinite(res.voltages).all()
    return res


if __name__ == "__main__":
    main()
