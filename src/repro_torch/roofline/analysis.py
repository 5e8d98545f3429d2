"""Three-term roofline of a dry-run cell, per card, against one H100's
numbers (the JAX package's ``roofline/analysis.py``).

  compute term    = FLOPs / PEAK_FLOPS
  memory term     = bytes accessed / HBM_BW
  collective term = collective bytes / LINK_BW

Every input is one card's: the dry run traces the step at the widths the
sharding rules leave one card (:mod:`repro_torch.launch.dryrun`), so the
reference's global = per_device * chips form cancels the same way.  The
FLOPs are the matmul operations PyTorch's ``FlopCounterMode`` counts; the
bytes accessed are each aten op's inputs plus outputs, fusion-blind like
the reference's CPU cost model, so the memory term is an upper bound.
Collective bytes are the result bytes of the collectives that the cell's
placements call for, counted by the dry run from its rules table (there is
no compiled program to read them from).

Hardware model (NVIDIA's H100 SXM data sheet, dense, at the full 700 W;
H100 constants, not measured): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and
NVLink 4 at 900 GB/s a card both ways, 450 GB/s one way.  The 256- and
512-card meshes span nodes of 8 cards, whose links between nodes are
slower than NVLink and are not modelled, so there the collective term is
a lower bound.  The reference's constants are a TPU v5e's (197 TFLOP/s,
819 GB/s HBM, 50 GB/s a link): they are the reference's, not the port's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Roofline", "analyze", "model_flops_for", "COLLECTIVES",
           "PEAK_FLOPS", "HBM_BW", "LINK_BW"]

PEAK_FLOPS = 989e12          # bf16 dense per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, NVLink 4, one direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # per card (the traced step's)
    hlo_bytes: float             # per card
    collective_bytes: float      # per card
    collective_detail: dict
    model_flops: float           # 6*N*D (or 6*N_active*D) useful flops, global
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self) -> "Roofline":
        self.compute_s = self.hlo_flops / PEAK_FLOPS
        self.memory_s = self.hlo_bytes / HBM_BW
        self.collective_s = self.collective_bytes / LINK_BW
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / traced FLOPs over the mesh: how much of the
        counted compute is useful."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flops / (bound_time * peak compute)."""
        denom = self.bound_s * self.chips * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "collective_detail": self.collective_detail,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape, n_active: Optional[int] = None) -> float:
    """6*N*D for train, 2*N*D for inference (per forward); D = tokens."""
    n = n_active if n_active is not None else cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    per_tok = 6 * n if shape.kind == "train" else 2 * n
    return float(per_tok) * tokens


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            cost: dict, collectives: dict, model_flops: float) -> Roofline:
    """``cost``: one card's ``{"flops", "bytes accessed"}``;
    ``collectives``: one card's result bytes by kind of
    :data:`COLLECTIVES`, with their op counts under ``"counts"``."""
    detail = {k: float(collectives.get(k, 0.0)) for k in COLLECTIVES}
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        collective_bytes=float(sum(detail.values())),
        collective_detail={**detail, "counts": dict(collectives.get("counts", {}))},
        model_flops=model_flops,
    ).finalize()
