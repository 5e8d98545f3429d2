"""Batched parameter sweep on the PyTorch port: N perturbed copies of a
circuit, one plan.

Monte-Carlo / process-corner analysis: every copy shares the sparsity
pattern, so the GLU symbolic plan is built once and each lockstep Newton
iterate factorizes all copies in one batched call
(``GLU.refactorize_solve``: one CUDA-graph replay on the card).
``--device cpu`` runs on the host.

  PYTHONPATH=src python examples/torch_transient_sweep.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.circuit import rc_grid_circuit, transient_sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--ny", type=int, default=8)
    ap.add_argument("--t-end", type=float, default=0.05)
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--corners", type=int, default=9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    ckt = rc_grid_circuit(args.nx, args.ny, with_diodes=True, seed=0)
    scales = np.linspace(0.8, 1.2, args.corners)   # +-20% conductance corners
    print(f"grid {args.nx}x{args.ny}: {ckt.n} nodes, sweeping {len(scales)} "
          f"corners {scales.round(2).tolist()}")
    res = transient_sweep(ckt, t_end=args.t_end, dt=args.dt, scales=scales,
                          device=args.device)
    print(f"steps={len(res.times)}  lockstep newton_iters="
          f"{res.newton_iters.sum()}  batched factorizations="
          f"{res.n_batched_factorizations} (x{len(scales)} matrices each)")
    print(f"symbolic setup {res.setup_seconds:.2f}s (once)  "
          f"numeric loop {res.solve_seconds:.2f}s")
    print(f"max Newton residual {res.max_residual:.2e}")
    v_final = res.voltages[:, -1, :]
    spread = v_final.max(axis=0) - v_final.min(axis=0)
    print(f"corner-to-corner final-voltage spread: "
          f"max {spread.max():.4f} V, mean {spread.mean():.4f} V")
    assert np.isfinite(res.voltages).all()
    return res


if __name__ == "__main__":
    main()
