"""End-to-end run on the PyTorch port: transient simulation of a
nonlinear power grid.

Backward-Euler + Newton-Raphson; the GLU plan is built once and hundreds
of refactorizations run on the fixed pattern, the paper's target
workload.  Runs on the card; ``--device cpu`` runs on the host.

  PYTHONPATH=src python examples/torch_circuit_transient.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.circuit import rc_grid_circuit, transient


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=10)
    ap.add_argument("--ny", type=int, default=10)
    ap.add_argument("--t-end", type=float, default=0.10)
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    ckt = rc_grid_circuit(args.nx, args.ny, with_diodes=True, seed=0)
    print(f"grid {args.nx}x{args.ny}: {ckt.n} nodes, {len(ckt.resistors)} R, "
          f"{len(ckt.capacitors)} C, {len(ckt.diodes)} diodes, "
          f"{len(ckt.isources)} switching loads")
    res = transient(ckt, t_end=args.t_end, dt=args.dt, device=args.device)
    print(f"steps={len(res.times)}  newton_iters={res.newton_iters.sum()}  "
          f"factorizations={res.n_factorizations}")
    print(f"symbolic setup {res.setup_seconds:.2f}s (once)  "
          f"numeric loop {res.solve_seconds:.2f}s "
          f"({res.solve_seconds / res.n_factorizations * 1e3:.2f} "
          f"ms/refactorize+solve)")
    print(f"max Newton residual {res.max_residual:.2e}")
    vmin, vmax = res.voltages.min(), res.voltages.max()
    print(f"voltage envelope [{vmin:.3f}, {vmax:.3f}] V")
    assert np.isfinite(res.voltages).all()
    return res


if __name__ == "__main__":
    main()
