"""Logical-axis sharding: one rules table maps logical names to mesh axes
(the JAX package's ``distributed/sharding.py``).

Parameters, caches and batches declare a logical name per dimension
(``("vocab", None)``, ``("batch", "kv_seq", "kv_heads", None)``); a
``(mesh, rules)`` environment resolves them to mesh axes.  Outside an
environment :func:`logical_constraint` is a no-op, so the same model code
runs on one device and under the dry run's production meshes.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or anything with
``mesh_dim_names`` and a ``shape`` of axis sizes (:class:`MeshShape`, which
needs no process group).  A resolved layout is a :class:`MeshSharding`: the
spec (per tensor dimension ``None``, a mesh-axis name, or a tuple of names,
as the reference's ``PartitionSpec``), its DTensor ``placements`` and the
per-card ``shard_shape``.

Robustness rule: a logical axis only shards if the dimension is divisible
by the product of its mesh-axis sizes, otherwise it replicates (8 Mixtral
experts on a 16-way model axis, whisper's 8 heads); and a mesh axis is
used once per spec, the first dimension that asks for it winning.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

__all__ = [
    "DEFAULT_RULES",
    "MeshShape",
    "MeshSharding",
    "axis_env",
    "current_env",
    "logical_constraint",
    "make_rules",
    "mesh_axes",
    "replicated",
    "sharding_for_spec",
    "spec_struct",
    "tree_shardings",
]

# logical name -> mesh axis (or tuple of axes, or None = replicate)
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "scenario": ("pod", "data"),  # batched-solver scenario axis (sweep copies)
    "seq": None,            # "model" enables sequence/context parallelism
    "kv_seq": None,         # "model" enables context-parallel decode
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "expert_ffn": "model",
    "experts": "model",
    "vocab": "model",
    "model": "model",       # identity for directly-annotated params
    "fsdp": "data",
}

_ENV: contextvars.ContextVar = contextvars.ContextVar("repro_torch_axis_env",
                                                      default=None)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes alone: what the rules read of a mesh."""

    mesh_dim_names: tuple
    shape: tuple


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` in mesh order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A tensor's layout on a mesh: ``spec`` holds, per tensor dimension,
    ``None`` (replicated), a mesh-axis name or a tuple of names (sharded
    over their product, the first outermost)."""

    mesh: object
    spec: tuple

    def _sizes(self, entry) -> int:
        axes = mesh_axes(self.mesh)
        names = entry if isinstance(entry, tuple) else (entry,)
        return math.prod(axes[a] for a in names if a is not None)

    def shard_shape(self, shape) -> tuple:
        """One card's block of a tensor of global ``shape``."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(d // self._sizes(s) for d, s in zip(shape, spec))

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dimension: ``Shard(i)`` where
        tensor dimension ``i`` shards over that mesh axis, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [i for i, s in enumerate(self.spec)
                    if s == name or (isinstance(s, tuple) and name in s)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def axes_used(self) -> set:
        used: set = set()
        for s in self.spec:
            if s is not None:
                used.update(s if isinstance(s, tuple) else (s,))
        return used


def replicated(mesh) -> MeshSharding:
    return MeshSharding(mesh, ())


def make_rules(cfg=None, **overrides) -> dict:
    """Per-arch rules: start from defaults, apply config knobs + overrides."""
    rules = dict(DEFAULT_RULES)
    if cfg is not None:
        if not cfg.attn_tp:
            rules["heads"] = None
            rules["kv_heads"] = None
        if getattr(cfg, "seq_shard", False):
            rules["seq"] = "model"   # sequence parallelism
    rules.update(overrides)
    return rules


@contextlib.contextmanager
def axis_env(mesh, rules: Optional[dict] = None):
    token = _ENV.set((mesh, rules or dict(DEFAULT_RULES)))
    try:
        yield
    finally:
        _ENV.reset(token)


def current_env():
    return _ENV.get()


def _resolve(name, dim: int, axes: dict, rules: dict, used: set | None = None):
    """Logical name -> mesh axis, tuple of mesh axes, or None.

    Guards: (a) the dim must divide the mesh-axis product, (b) a mesh axis
    may appear only once per spec — first dim wins, later dims replicate
    (e.g. MoE weights where both 'experts' and 'expert_ffn' map to 'model')."""
    if name is None:
        return None
    ax = rules.get(name)
    if ax is None:
        return None
    names = ax if isinstance(ax, tuple) else (ax,)
    names = tuple(a for a in names if a in axes and (used is None or a not in used))
    if not names:
        return None
    size = math.prod(axes[a] for a in names)
    if size == 0 or dim % size != 0:
        return None
    if used is not None:
        used.update(names)
    return names if len(names) > 1 else names[0]


def _resolve_spec(names, shape, mesh, rules: dict) -> list:
    axes, used = mesh_axes(mesh), set()
    return [_resolve(nm, shape[i], axes, rules, used) for i, nm in enumerate(names)]


def logical_constraint(x, *names):
    """``x`` unchanged outside an environment; inside one a DTensor is
    redistributed to the placements its names resolve to (a plain tensor
    is returned as it is)."""
    env = _ENV.get()
    if env is None:
        return x
    mesh, rules = env
    if len(names) != x.ndim:
        raise ValueError(f"{len(names)} names for rank-{x.ndim} array")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sh = MeshSharding(mesh, tuple(_resolve_spec(names, x.shape, mesh, rules)))
    return x.redistribute(mesh, sh.placements)


def sharding_for_spec(shape, axes, mesh, rules: dict,
                      fsdp: bool = False) -> MeshSharding:
    """Parameter sharding from a leaf's logical axes; with ``fsdp`` the
    first replicated dim that divides the data axis and is at least 512
    additionally shards over it (ZeRO-3-style weight sharding)."""
    spec = _resolve_spec(axes, shape, mesh, rules)
    sizes = mesh_axes(mesh)
    used = MeshSharding(mesh, tuple(spec)).axes_used()
    if fsdp and "data" in sizes and "data" not in used:
        dsize = sizes["data"]
        for i, s in enumerate(spec):
            if s is None and shape[i] % dsize == 0 and shape[i] >= 512:
                spec[i] = "data"
                break
    return MeshSharding(mesh, tuple(spec))


def tree_shardings(specs: dict, mesh, rules: dict, fsdp: bool = False) -> dict:
    """``{name: (shape, dtype, axes)}`` -> ``{name: MeshSharding}``."""
    return {name: sharding_for_spec(shape, axes, mesh, rules, fsdp)
            for name, (shape, _dtype, axes) in specs.items()}


def spec_struct(specs: dict, device="meta") -> dict:
    """``{name: (shape, dtype, axes)}`` -> ``{name: empty tensor}`` of those
    shapes and dtypes on ``device``: on ``"meta"``, or under a
    ``FakeTensorMode``, they hold no memory (the dry run's inputs)."""
    import torch

    from ..models.layers import torch_dtype

    return {name: torch.empty(shape, dtype=torch_dtype(dtype), device=device)
            for name, (shape, dtype, _axes) in specs.items()}
