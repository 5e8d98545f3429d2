"""Production and host meshes (functions, not constants: importing this
module touches no process group).

A host mesh is a ``("data", "model")`` ``DeviceMesh`` over the ranks of
this process's default group: one process a rank, as
``python -m torch.distributed.run`` starts them, each on its own card over
NCCL (``cuda:LOCAL_RANK``), or over gloo on the CPU.  A process that no
launcher started is a group of one.

The production meshes are the reference's 16x16 ``("data", "model")``
(256 cards) and 2x16x16 ``("pod", "data", "model")`` (512 cards).  No
machine here has 512 cards, so they are ``DeviceMesh`` objects over a
fake process group of 512 ranks whose collectives do nothing: the
counterpart of the reference's ``--xla_force_host_platform_device_count``.
The dry run reads their axis names and sizes; nothing runs on them.  A
process initialises its default group once, so only a process of its own
(the dry run's CLI, a test's subprocess) builds them.
"""
from __future__ import annotations

import math
import os
import socket

import torch

__all__ = ["make_production_mesh", "make_host_mesh", "rank_device",
           "PRODUCTION_RANKS"]

PRODUCTION_RANKS = 512


def rank_device(device=None) -> torch.device:
    """This rank's device: ``"cpu"``, or the card of its local rank
    (``LOCAL_RANK``, 0 without a launcher); NCCL takes one rank a card, so
    a rank without a card of its own raises."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    local, count = int(os.environ.get("LOCAL_RANK", 0)), torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"local rank {local} has no card of its own ({count} "
                           f"visible); NCCL takes one rank a card")
    return torch.device("cuda", local)


def _default_group(world: int, fake: bool, device=None) -> int:
    """The world size of this process's default group, which is
    initialised here when there is none: a fake group of ``world`` ranks;
    the group a launcher describes (``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR``/``MASTER_PORT`` in the environment, as
    ``torch.distributed.run`` sets them); or a group of this one process.
    A real group is NCCL's on the cards and gloo's on the CPU; each rank
    takes :func:`rank_device`."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if fake:
            # PyTorch's private testing module: a store and a "fake"
            # backend whose collectives return at once and move nothing
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            return dist.get_world_size()
        dev = rank_device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{port}", rank=0,
                world_size=1)
    return dist.get_world_size()


def _mesh(device: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 cards) or 2x16x16 multi-pod (512 cards), over
    a fake group of 512 ranks (the 16x16 mesh takes the first 256)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _default_group(PRODUCTION_RANKS, fake=True)
    if world < math.prod(shape):
        raise RuntimeError(f"the default process group has {world} ranks; the "
                           f"{'x'.join(map(str, shape))} mesh needs "
                           f"{math.prod(shape)} (build it in a process of its own)")
    return _mesh("cpu", shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``("data", "model")`` mesh over the ranks of this process's group
    (initialised here when there is none, see :func:`_default_group`; on
    ``device``'s type, the card by default when there is one): when
    ``data * model`` exceeds the ranks it shrinks to ``(ranks, 1)``, as
    the reference's does over its devices."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    n = _default_group(1, fake=False, device=device)
    if data * model > n:
        data, model = n, 1
    return _mesh(torch.device(device).type, (data, model), ("data", "model"))
