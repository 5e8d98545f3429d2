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

On a real ``DeviceMesh`` (one process a rank) the same rules place real
DTensors: :func:`distribute_model` turns a model's parameters into
DTensors placed as :func:`tree_shardings` says, :func:`distribute_batch`
shards a batch's leading axis as ``("batch", None, ...)`` resolves, and
:func:`local_fallback` runs an op that has no DTensor sharding rule on the
local tensors of placements it can take (replicated over ``model``).
Inside :func:`axis_env` on such a mesh, plain tensors that meet DTensors
in an op (positions, masks, rotary tables) count as replicated.

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
    "batch_sharding",
    "current_env",
    "distribute",
    "distribute_batch",
    "distribute_model",
    "env_placements",
    "is_dtensor",
    "local_fallback",
    "local_rows",
    "logical_constraint",
    "moment_sharding",
    "on_mesh",
    "param_shardings",
    "plain_as_replicated",
    "replicate",
    "shard_of",
    "spec_of",
    "summed_over",
    "zeros_on",
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
# environments on a real DeviceMesh, seen from every thread: on the card
# autograd runs the backward, and so each remat layer's recomputed
# forward, on threads of its own, where the context variable is unset
_MESH_ENVS: list = []


def _env():
    env = _ENV.get()
    return _MESH_ENVS[-1] if env is None and _MESH_ENVS else env


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


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


@contextlib.contextmanager
def axis_env(mesh, rules: Optional[dict] = None):
    """Resolve logical names on ``mesh`` inside the block; on a real
    ``DeviceMesh`` plain tensors that meet DTensors count as replicated
    (on this thread), and the environment holds on every thread (the
    backward's too) until the block ends."""
    env = (mesh, rules or dict(DEFAULT_RULES))
    token = _ENV.set(env)
    try:
        if _is_device_mesh(mesh):
            _MESH_ENVS.append(env)
            try:
                with plain_as_replicated():
                    yield
            finally:
                _MESH_ENVS.pop()
        else:
            yield
    finally:
        _ENV.reset(token)


@contextlib.contextmanager
def plain_as_replicated():
    """Plain tensors that meet DTensors in an op count as replicated
    inside the block, the caller's setting restored after (PyTorch's
    ``implicit_replication`` turns it off on leaving, even when nested)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def current_env():
    return _env()


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
    env = _env()
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


# ---------------------------------------------------------------------------
# DTensors on a real mesh
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def spec_of(x) -> tuple:
    """The spec of a DTensor's placements (per tensor dimension ``None``,
    a mesh-axis name or a tuple of names, the outermost first)."""
    from torch.distributed.tensor import Shard

    spec: list = [()] * x.ndim
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            spec[pl.dim] = spec[pl.dim] + (name,)
    return tuple(None if not s else s[0] if len(s) == 1 else s for s in spec)


def shard_of(full, mesh, placements):
    """This rank's block of ``full`` under ``placements`` on ``mesh`` (the
    mesh's first dimension outermost where two shard one tensor
    dimension), a view of ``full``; every rank holds ``full``, nothing
    moves between ranks.  The dimensions must divide."""
    from torch.distributed.tensor import Partial, Shard

    local = full
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Partial):
            raise ValueError("a full tensor has no partial shard")
        if isinstance(pl, Shard):
            n = mesh.size(mdim)
            if local.shape[pl.dim] % n:
                raise ValueError(f"dimension {pl.dim} of {tuple(full.shape)} "
                                 f"does not divide over {n} ranks")
            local = local.chunk(n, dim=pl.dim)[mesh.get_local_rank(mdim)]
    return local


def distribute(full, mesh, placements):
    """A DTensor of ``full`` (which every rank holds alike) placed as
    ``placements``: each rank keeps a copy of its block."""
    from torch.distributed.tensor import DTensor

    full = full.contiguous()
    return DTensor.from_local(shard_of(full, mesh, placements).clone(), mesh,
                              placements, run_check=False, shape=full.shape,
                              stride=full.stride())


def zeros_on(shape, sharding: MeshSharding, dtype, device):
    """A zero DTensor of global ``shape`` placed as ``sharding``, only the
    local block allocated."""
    import torch
    from torch.distributed.tensor import DTensor

    local = torch.zeros(sharding.shard_shape(shape), dtype=dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def replicate(x):
    """A DTensor redistributed to be whole on every rank (a partial sum
    reduced); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def param_shardings(cfg, mesh, rules: dict) -> dict:
    """``{parameter name: MeshSharding}`` of an LM's parameters: the
    reference's launcher's ``tree_shardings(param_specs(cfg), mesh,
    rules, fsdp=cfg.fsdp)``."""
    from ..models.model import param_axes, param_specs

    axes = param_axes(cfg)
    specs = {n: (shape, dt, axes[n]) for n, (shape, dt) in param_specs(cfg).items()}
    return tree_shardings(specs, mesh, rules, fsdp=cfg.fsdp)


def moment_sharding(param_sharding: MeshSharding, stacked: bool,
                    drop: Optional[int] = None) -> MeshSharding:
    """An optimizer moment's layout from its parameter's: a leading layer
    axis when ``stacked`` (replicated), and dimension ``drop`` of the
    (stacked) leaf reduced away (Adafactor's row and column statistics)."""
    spec = list(param_sharding.spec)
    if stacked:
        spec.insert(0, None)
    if drop is not None:
        spec = (spec + [None] * (drop + 1 - len(spec)))
        del spec[drop]
    return MeshSharding(param_sharding.mesh, tuple(spec))


def distribute_model(model, mesh, rules: dict):
    """Every parameter of ``model`` (an LM whose parameters are whole on
    every rank) replaced by a DTensor placed by :func:`param_shardings`;
    each rank keeps its blocks.  Returns ``model``."""
    import torch

    shardings = param_shardings(model.cfg, mesh, rules)
    for name, p in list(model.named_parameters()):
        owner, leaf = _owner(model, name)
        setattr(owner, leaf, torch.nn.Parameter(
            distribute(p.detach(), mesh, shardings[name].placements),
            requires_grad=p.requires_grad))
    return model


def _owner(module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def batch_sharding(shape, mesh, rules: dict) -> MeshSharding:
    """A batch leaf's layout: ``("batch", None, ...)`` resolved."""
    names = ("batch",) + (None,) * (len(shape) - 1)
    return MeshSharding(mesh, tuple(_resolve_spec(names, shape, mesh, rules)))


def distribute_batch(batch: dict, mesh, rules: dict, device) -> dict:
    """A batch (numpy arrays or tensors, each rank holding the same whole
    batch) as DTensors on ``device``, their leading axis sharded as
    ``"batch"`` resolves; each rank copies only its block to ``device``."""
    import numpy as np
    import torch

    out = {}
    for k, v in batch.items():
        full = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = distribute(full, mesh, batch_sharding(
            tuple(full.shape), mesh, rules).placements).to(device)
    return out


def env_placements(names, shape) -> tuple:
    """The placements that logical ``names`` resolve to for a tensor of
    ``shape`` in the current environment."""
    mesh, rules = _env()
    return MeshSharding(mesh, tuple(_resolve_spec(names, shape, mesh, rules))).placements


def local_rows(placements, mesh, size: int, dim: int = 1) -> tuple:
    """(offset, rows): this rank's block of dimension ``dim`` (``size``
    long) of a tensor placed as ``placements`` on ``mesh``, as
    :func:`shard_of` cuts it; ``(0, size)`` where no mesh axis shards it.
    A local function over a sequence-sharded tensor reads its rows'
    positions from it (an attention core's mask rows)."""
    from torch.distributed.tensor import Shard

    offset, rows = 0, size
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            rows //= mesh.size(mdim)
            offset += mesh.get_local_rank(mdim) * rows
    return offset, rows


def summed_over(placements) -> tuple:
    """The placements of a sum over the sharded dimensions of a tensor
    placed as ``placements``: a partial sum over the mesh axes that shard
    it, replicated over the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Partial() if isinstance(p, Shard) else Replicate() for p in placements)


def on_mesh() -> bool:
    """Whether the current environment is on a real ``DeviceMesh``."""
    env = _env()
    return env is not None and _is_device_mesh(env[0])


def local_fallback(fn, args: tuple, ins: tuple, outs, grads: tuple):
    """``fn(*args)`` for an op that has no DTensor sharding rule: each
    DTensor argument is redistributed to its placements in ``ins`` (None
    for an argument that is not a tensor), ``fn`` runs on the local
    tensors, and its outputs come back as DTensors placed as ``outs`` (one
    placements tuple, or a list of them for a tuple of outputs).
    ``grads`` are the placements of the gradients ``fn``'s backward gives
    its inputs: a partial sum where each rank's gradient is its share of
    one.  Off a real mesh, or without a DTensor argument (the dry run's
    plain tensors), ``fn(*args)`` runs as it is."""
    if not (on_mesh() and any(map(is_dtensor, args))):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    # local_map reads a tuple as one entry an output, a list as one
    # output's placements
    outs = tuple(map(tuple, outs)) if isinstance(outs, list) else list(outs)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=_env()[0],
                     redistribute_inputs=True)(*args)
