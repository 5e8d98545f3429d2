"""AC small-signal frequency sweep on the PyTorch port: one complex plan,
all points batched.

The sweep factorizes A(w) = G + jwC at every frequency on one symbolic
plan: the DC operating point comes from the real-valued Newton loop,
then one batched complex128 factorize+solve covers all F points in
lockstep (``GLU.refactorize_solve``).  ``--layout native`` takes the
native complex route (every level a flat step, the dense tail on K3)
instead of the default planar one.  Runs on the card; ``--device cpu``
runs on the host.

  PYTHONPATH=src python examples/torch_ac_sweep.py [--layout native] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.circuit import ac_sweep, rc_grid_circuit


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--ny", type=int, default=8)
    ap.add_argument("--points", type=int, default=21)
    ap.add_argument("--layout", default="auto",
                    choices=("auto", "planar", "native"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    ckt = rc_grid_circuit(args.nx, args.ny, with_diodes=True, seed=0)
    ckt.add_ac_current_source(1, 0, 1.0)   # 1A small-signal probe at node 1
    freqs = np.logspace(0, 5, args.points)
    print(f"grid {args.nx}x{args.ny}: {ckt.n} nodes, sweeping {len(freqs)} "
          f"frequency points [{freqs[0]:.0f} Hz .. {freqs[-1]:.0f} Hz], "
          f"layout {args.layout}")
    res = ac_sweep(ckt, freqs, layout=args.layout, device=args.device)
    print(f"operating point found in {res.op_newton_iters} Newton iters; "
          f"batched complex factorizations: {res.n_batched_factorizations}")
    print(f"setup {res.setup_seconds:.2f}s (op point + one complex plan)  "
          f"sweep solve {res.solve_seconds:.3f}s "
          f"({res.solve_seconds / len(freqs) * 1e3:.2f} ms/point)")
    print(f"worst componentwise backward error {res.max_backward_error:.2e}")
    mag = np.abs(res.voltages[:, 0])
    print("probe-node |V(f)|:")
    for f, m in zip(freqs[::4], mag[::4]):
        print(f"  {f:>9.1f} Hz  {m:.4e} V")
    assert res.max_backward_error < 1e-10
    assert (np.diff(mag) <= 1e-12).all(), "RC grid must be low-pass at the probe"
    return res


if __name__ == "__main__":
    main()
