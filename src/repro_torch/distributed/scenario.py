"""Scenario-axis sharding for the batched refactorize/solve engine.

A sweep batch (Monte-Carlo copies, corners, AC frequencies) is parallel
across scenarios: every batched step of the executors works row by row and
every per-matrix reduction (``max|A|``, pivot growth, backward error)
stays within its own row.  :class:`ScenarioSharding` maps that leading
axis onto the devices of a :class:`SweepMesh` (the ``"scenario"`` rule of
the logical-axis table, :data:`repro_torch.distributed.sharding.DEFAULT_RULES`,
resolved against a 1-D ``("data",)`` mesh): a value or
right-hand-side batch splits into contiguous row blocks, one a device,
while each shard owns its copy of the plan's schedule (index tensors,
buffers, CUDA graphs) on its device and runs the whole schedule on its
block, one graph replay a shard.

One process drives every device, as the JAX package's single-controller
``shard_map`` does: each shard's work is issued on its own card's stream
and nothing here uses ``torch.distributed``.

As in the JAX package, a mesh that resolves to a single shard yields
``None`` (run unsharded).  Batch divisibility is handled one level up (the ``GLU``
facade pads the batch); the executors run a batch that the shard count
does not divide unsharded.

A mesh may repeat a device (``make_sweep_mesh(devices=["cpu"] * 8)``):
the counterpart of the JAX package's
``--xla_force_host_platform_device_count``, so that the CPU and a one-card
machine run the sharded path for real.  Shards on one device then run one
after another on that device: a timing taken so is emulated, never a
scaling figure.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["ScenarioSharding", "ShardedBatch", "SweepMesh",
           "batch_blocks", "check_mesh", "gather_rows", "make_scenario_sharding",
           "make_sweep_mesh", "map_blocks"]

@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """A 1-D ``("data",)`` mesh: the devices a sweep's scenarios split over,
    in shard order.  A device may appear more than once (emulation)."""

    devices: tuple


@dataclasses.dataclass(frozen=True)
class ScenarioSharding:
    """The devices the scenario (batch) axis splits over along the mesh's
    ``"data"`` axis, one shard each."""

    devices: tuple

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def spec(self) -> str:
        """The partition spec, spelled as the JAX package reports it in
        ``solve_info["batch_spec"]``."""
        return "PartitionSpec('data',)"

    @property
    def descriptor(self) -> tuple:
        """Hashable identity for cache keys: axis sizes and device indices,
        so sharded and unsharded schedules (and shards of different
        meshes) never share a key."""
        return ((("data", self.n_shards),),
                tuple((d.type, d.index) for d in self.devices))

    def pad(self, batch: int) -> int:
        """Smallest multiple of ``n_shards`` >= batch."""
        k = self.n_shards
        return ((batch + k - 1) // k) * k

    def split(self, x) -> list:
        """Contiguous row blocks of a (B, ...) array or tensor, one a shard
        (views, nothing copied); B must be a multiple of ``n_shards``."""
        B, k = x.shape[0], self.n_shards
        if B % k:
            raise ValueError(f"a batch of {B} does not split over {k} shards")
        m = B // k
        return [x[i * m:(i + 1) * m] for i in range(k)]


class ShardedBatch:
    """A (B, ...) batch held as contiguous row blocks, block i a tensor on
    shard i's device: what the executors return for a sharded batch (the
    counterpart of a batch-sharded JAX array)."""

    def __init__(self, sharding: ScenarioSharding, parts):
        self.sharding = sharding
        self.parts = tuple(parts)

    @property
    def shape(self) -> tuple:
        p = self.parts[0]
        return (sum(q.shape[0] for q in self.parts),) + tuple(p.shape[1:])

    def dim(self) -> int:
        return self.parts[0].dim()



# A batch the executors hand back is a tensor (unsharded) or a
# ShardedBatch: these three are all a caller needs to handle both alike.

def batch_blocks(batch) -> tuple:
    """The row blocks of a batch: a sharded one's, or the tensor alone."""
    return batch.parts if isinstance(batch, ShardedBatch) else (batch,)


def map_blocks(batch, fn):
    """``fn`` applied to every row block on its device, in the batch's
    form (a tensor for a tensor)."""
    if isinstance(batch, ShardedBatch):
        return ShardedBatch(batch.sharding, [fn(p) for p in batch.parts])
    return fn(batch)


def gather_rows(batch, device, rows: int) -> torch.Tensor:
    """The batch's first ``rows`` rows as one tensor on ``device`` (a view
    of an unsharded batch; a sharded one's blocks are copied there)."""
    if isinstance(batch, ShardedBatch):
        batch = torch.cat([p.to(device) for p in batch.parts])
    return batch[:rows]


def check_mesh(mesh) -> Optional[SweepMesh]:
    """``mesh`` itself when it is None or a :class:`SweepMesh`; anything
    else raises ``TypeError`` (before any planning work)."""
    if mesh is not None and not isinstance(mesh, SweepMesh):
        raise TypeError(f"mesh must be a SweepMesh (see make_sweep_mesh), "
                        f"got {type(mesh).__name__}")
    return mesh


def make_scenario_sharding(mesh: Optional[SweepMesh]
                           ) -> Optional[ScenarioSharding]:
    """The scenario axis over ``mesh``'s devices.

    Returns ``None`` when no mesh is given or it has one device (callers
    treat that as "run unsharded")."""
    if check_mesh(mesh) is None or len(mesh.devices) < 2:
        return None
    return ScenarioSharding(devices=tuple(mesh.devices))


def make_sweep_mesh(n_devices: Optional[int] = None,
                    devices=None) -> SweepMesh:
    """A 1-D ``("data",)`` mesh for scenario sweeps.

    ``devices`` defaults to every CUDA card of the host (raises when there
    is none: the port never shards onto the CPU in silence).  An explicit
    list may name the CPU and may repeat a device, which runs the sharded
    path with its shards one after another on that device (emulation; see
    the module docstring).  ``n_devices`` takes the first that many and
    raises ``ValueError`` when there are fewer."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(e.g. ['cpu'] * 4) to emulate a mesh")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_indexed(resolve_device(d)) for d in devices]
    if n_devices is not None:
        if n_devices < 1 or n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a sweep mesh needs at least one device")
    return SweepMesh(devices=tuple(devs))


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` -> the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
