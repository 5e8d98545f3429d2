"""Carry a plan across packages as plain numpy arrays.

A plan plays the part that weights play in a model: ``plan_to_arrays``
reads any object with the fields of a ``FactorizePlan`` (or of a
``SymbolicPlan``, whose factorize plan sits in ``fplan``) into a flat dict
of numpy arrays, ints and strings, and ``plan_from_arrays`` /
``symbolic_plan_from_arrays`` build this package's plans from such a dict.
So a plan made by the JAX package's planner can drive this package's
executors, which holds the numerics apart from the planner.

An LM's parameters travel the same way: ``lm_params_from_arrays`` fills an
:class:`~repro_torch.models.LM` from a parameter tree in the JAX package's
layout (nested dicts and lists of numpy arrays, scan-stacked layer
patterns included), and ``lm_params_to_arrays`` gives such a tree back.
numpy has no bfloat16, so the arrays are float32 (which holds bfloat16
values exactly) and the model casts them to ``cfg.dtype``.  The same walk
(:func:`reference_layout`: each leaf's path and the port parameters it
holds) gives gradients and optimizer states in that layout, and the
dtype-keeping tensor tree a checkpoint stores.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .core.dependency import Levelization
from .core.plan import FactorizePlan, LevelSegment
from .core.planner import SymbolicPlan
from .core.symbolic import FilledPattern

__all__ = ["plan_to_arrays", "plan_from_arrays", "symbolic_plan_from_arrays",
           "lm_params_from_arrays", "lm_params_to_arrays", "lm_params_to_tensors",
           "load_lm_params", "lm_grads_to_arrays", "opt_state_to_arrays",
           "opt_state_from_arrays", "reference_layout", "flatten_paths",
           "nest_paths"]

# FactorizePlan fields carried as arrays, in their dataclass order
_FPLAN_ARRAYS = (
    "indptr", "indices", "diag_idx", "norm_idx", "norm_diag", "lidx", "uidx",
    "didx", "dst_col", "a_scatter", "fwd_rows", "fwd_cols", "fwd_vidx",
    "fwd_ptr", "bwd_rows", "bwd_cols", "bwd_vidx", "bwd_ptr",
    "bwd_level_cols", "bwd_col_ptr", "l_adj_ptr", "l_adj_rows", "u_adj_ptr",
    "u_adj_rows",
)
# SymbolicPlan fields carried as arrays
_SPLAN_ARRAYS = (
    "orig_indptr", "orig_indices", "row_perm", "row_map", "col_map",
    "inv_row", "perm_indptr", "perm_indices", "data_perm", "spmv_rows",
    "spmv_cols",
)


def plan_to_arrays(plan) -> dict:
    """Flat dict of a FactorizePlan's (or SymbolicPlan's) fields."""
    d = {}
    fplan = getattr(plan, "fplan", None)
    if fplan is not None:
        for k in _SPLAN_ARRAYS:
            d[k] = np.asarray(getattr(plan, k))
        d.update(key=plan.key, ordering=plan.ordering, symbolic=plan.symbolic,
                 panel_threshold=int(plan.panel_threshold),
                 pattern_indptr=np.asarray(plan.pattern.indptr),
                 pattern_indices=np.asarray(plan.pattern.indices),
                 pattern_a_scatter=np.asarray(plan.pattern.a_scatter),
                 pattern_method=plan.pattern.method)
        plan = fplan
    d.update(n=int(plan.n), nnz=int(plan.nnz), digest=plan.digest)
    for k in _FPLAN_ARRAYS:
        d[k] = np.asarray(getattr(plan, k))
    d["levels"] = np.asarray(plan.levels.levels)
    d["level_order"] = np.asarray(plan.levels.order)
    d["level_ptr"] = np.asarray(plan.levels.level_ptr)
    segs = plan.segments
    d["segment_norm"] = np.asarray(
        [[s.norm_slice.start, s.norm_slice.stop] for s in segs],
        dtype=np.int64).reshape(-1, 2)
    d["segment_upd"] = np.asarray(
        [[s.upd_slice.start, s.upd_slice.stop] for s in segs],
        dtype=np.int64).reshape(-1, 2)
    d["segment_modes"] = np.asarray([s.mode for s in segs], dtype=str)
    d["segment_levels"] = np.asarray([s.level for s in segs], dtype=np.int64)
    return d


def plan_from_arrays(d: dict) -> FactorizePlan:
    """This package's FactorizePlan from a :func:`plan_to_arrays` dict.
    Segment columns come from the levelization (segment ``l`` covers the
    columns of its level)."""
    lv = Levelization(levels=np.asarray(d["levels"]),
                      order=np.asarray(d["level_order"]),
                      level_ptr=np.asarray(d["level_ptr"]))
    segments = []
    for level, (ns, ne), (us, ue), mode in zip(
            d["segment_levels"], d["segment_norm"], d["segment_upd"],
            d["segment_modes"]):
        segments.append(LevelSegment(
            level=int(level), cols=lv.columns_at(int(level)),
            norm_slice=slice(int(ns), int(ne)),
            upd_slice=slice(int(us), int(ue)), mode=str(mode)))
    return FactorizePlan(
        n=int(d["n"]), nnz=int(d["nnz"]), levels=lv, segments=segments,
        digest=str(d["digest"]),
        **{k: np.asarray(d[k]) for k in _FPLAN_ARRAYS})


def symbolic_plan_from_arrays(d: dict) -> SymbolicPlan:
    """This package's SymbolicPlan (permutations, scatter maps, the filled
    pattern and the factorize plan) from a :func:`plan_to_arrays` dict of
    a SymbolicPlan."""
    fplan = plan_from_arrays(d)
    pattern = FilledPattern(n=fplan.n, indptr=np.asarray(d["pattern_indptr"]),
                            indices=np.asarray(d["pattern_indices"]),
                            a_scatter=np.asarray(d["pattern_a_scatter"]),
                            method=str(d["pattern_method"]))
    return SymbolicPlan(
        n=fplan.n, key=str(d["key"]), ordering=str(d["ordering"]),
        symbolic=str(d["symbolic"]),
        panel_threshold=int(d["panel_threshold"]), pattern=pattern,
        levelization=fplan.levels, fplan=fplan, build_seconds={},
        **{k: np.asarray(d[k]) for k in _SPLAN_ARRAYS})


# ---------------------------------------------------------------------------
# LM parameters: the JAX package's layer groups (its parameter layout)
# ---------------------------------------------------------------------------

def _lcm(a, b):
    return a * b // math.gcd(a, b)


def use_scan(cfg) -> bool:
    return (
        getattr(cfg, "scan_layers", True)
        and cfg.encoder_layers == 0
        and cfg.num_layers >= 8
    )


def layer_groups(cfg) -> list[dict]:
    """The JAX package's groups: [{start, indices | (repeat, period)} ...]
    covering all layers; a ``scan`` group stacks its pattern's parameters
    along a leading axis of length ``repeat``, layer ``start + r * period
    + pos`` at index ``r`` of pattern position ``pos``."""
    Lr = cfg.num_layers
    if not use_scan(cfg):
        return [{"start": 0, "scan": False, "indices": list(range(Lr))}]
    period = 1
    if cfg.attn_every:
        period = _lcm(period, cfg.attn_every)
    if cfg.n_experts and cfg.moe_every > 1:
        period = _lcm(period, cfg.moe_every)
    start = cfg.first_dense
    body = Lr - start
    repeat = body // period
    rem_start = start + repeat * period
    groups: list[dict] = []
    if start:
        groups.append({"start": 0, "scan": False, "indices": list(range(start))})
    if repeat >= 2:
        groups.append({"start": start, "scan": True, "repeat": repeat, "period": period})
    else:
        groups.append({"start": start, "scan": False,
                       "indices": list(range(start, rem_start))})
    if rem_start < Lr:
        groups.append({"start": rem_start, "scan": False,
                       "indices": list(range(rem_start, Lr))})
    return groups


def _layer_paths(cfg) -> dict:
    """Layer ``i`` -> (its path prefix in the JAX package's tree, its row
    in the scan-stacked leaves or None)."""
    where = {}
    for gi, g in enumerate(layer_groups(cfg)):
        if not g["scan"]:
            for li, i in enumerate(g["indices"]):
                where[i] = (f"blocks/{gi}/layers/{li}", None)
            continue
        for pos in range(g["period"]):
            for r in range(g["repeat"]):
                where[g["start"] + r * g["period"] + pos] = (
                    f"blocks/{gi}/pattern/{pos}", r)
    return where


def reference_layout(cfg) -> dict:
    """``{path: (names, stacked)}``: each leaf of the JAX package's
    parameter tree under its ``"/"``-joined path (``"embed"``,
    ``"blocks/1/pattern/0/attn/wq"``), with the port parameter names it
    holds: a scan group's leaf (``stacked``) one a row, in row order,
    another leaf one.  Paths come in the order of the port's parameters."""
    from .models.model import param_specs

    where = _layer_paths(cfg)
    out: dict = {}
    for name in param_specs(cfg):
        parts = name.split(".")
        row = None
        if parts[0] == "layers":
            prefix, row = where[int(parts[1])]
            parts = [prefix, *parts[2:]]
        names, _ = out.setdefault("/".join(parts), ([], row is not None))
        names.append(name)
    return out


def flatten_paths(tree) -> dict:
    """``{"/"-joined path: leaf}`` of nested dicts and lists, dict keys in
    sorted order (as the JAX package orders a tree's leaves)."""
    out: dict = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = sorted(node.items())
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix[:-1]] = node
            return
        for key, sub in items:
            walk(sub, f"{prefix}{key}/")

    walk(tree, "")
    return out


def nest_paths(flat: dict) -> dict:
    """The inverse of :func:`flatten_paths`: a dict whose keys are all
    digits becomes a list."""
    tree: dict = {}
    for path, leaf in flat.items():
        node, keys = tree, path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf

    def listed(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listed(node[str(i)]) for i in range(len(node))]
        return {k: listed(v) for k, v in node.items()}

    return listed(tree)


def _to_reference_tree(cfg, leaves: dict, stack=np.stack) -> dict:
    """The JAX package's parameter tree from ``{port name: leaf}`` (the
    parameters, or anything shaped like them: gradients, moments), the
    rows of each scan group joined with ``stack``."""
    return nest_paths({
        path: stack([leaves[n] for n in names]) if stacked else leaves[names[0]]
        for path, (names, stacked) in reference_layout(cfg).items()})


def _reference_leaves(cfg, tree: dict) -> dict:
    """``{port name: array}`` from the JAX package's parameter tree: each
    scan-stacked leaf split into its rows."""
    flat = flatten_paths(tree)
    layout = reference_layout(cfg)
    if flat.keys() != layout.keys():
        missing = [n for path in layout.keys() - flat.keys()
                   for n in layout[path][0]]
        raise KeyError(f"parameter tree of {cfg.name}: missing {sorted(missing)}, "
                       f"unexpected {sorted(flat.keys() - layout.keys())}")
    out = {}
    for path, (names, stacked) in layout.items():
        leaf = flat[path]
        if stacked and leaf.shape[0] != len(names):
            raise ValueError(f"{path}: {leaf.shape[0]} stacked rows for "
                             f"{len(names)} layers")
        for r, name in enumerate(names):
            out[name] = leaf[r] if stacked else leaf
    return out


def _whole(t):
    """A DTensor gathered whole (every rank of its mesh takes part); any
    other tensor as it is."""
    from .distributed.sharding import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


def load_lm_params(model, tree: dict):
    """Copy a parameter tree in the JAX package's layout (numpy arrays or
    tensors, on any device) into ``model``'s parameters, each cast to its
    parameter's dtype.  Every leaf must be there with its parameter's
    shape, and no other.  A DTensor parameter takes its block of the
    whole leaf.  Returns ``model``."""
    from .distributed.sharding import is_dtensor, shard_of

    leaves = _reference_leaves(model.cfg, tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = leaves[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)}, expected "
                                 f"{tuple(p.shape)}")
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
                a = torch.from_numpy(a if a.flags.writeable else a.copy())
            if is_dtensor(p):
                p.to_local().copy_(shard_of(a, p.device_mesh, p.placements))
            else:
                p.copy_(a)
    return model


def lm_params_from_arrays(cfg, tree: dict, device=None):
    """An :class:`LM` on ``device`` (``None``: the card) holding the
    parameters of ``tree``, a parameter tree in the JAX package's layout
    whose leaves are numpy arrays (float32 for bfloat16 weights); each is
    cast to its parameter's dtype (see :func:`load_lm_params`)."""
    from .models.model import LM
    return load_lm_params(LM(cfg, device), tree)


def _host_arrays(named) -> dict:
    return {n: _whole(t.detach()).float().cpu().numpy().copy() for n, t in named}


def lm_params_to_arrays(model) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the JAX package's
    parameter tree (scan groups stacked) of float32 numpy arrays."""
    return _to_reference_tree(model.cfg, _host_arrays(model.named_parameters()))


def lm_params_to_tensors(model) -> dict:
    """The JAX package's parameter tree of the parameters in their own
    dtypes (bfloat16 kept) on the model's device: a scan group's rows
    stacked into a new tensor, any other leaf the parameter itself
    (detached).  What a checkpoint stores."""
    return _to_reference_tree(
        model.cfg, {n: p.detach() for n, p in model.named_parameters()},
        torch.stack)


def lm_grads_to_arrays(model, grads: dict) -> dict:
    """Gradients ``{port name: tensor}`` (as ``make_train_step`` and
    ``grads_of`` give them) in the layout of the JAX package's gradient
    tree, float32 numpy arrays."""
    return _to_reference_tree(model.cfg, _host_arrays(
        (n, grads[n]) for n, _ in model.named_parameters()))


def opt_state_to_arrays(state: dict) -> dict:
    """An optimizer state of :mod:`repro_torch.train.optimizer` (its
    moments keyed by the JAX package's leaf paths) as that package's
    state tree: ``{"step": int32, "m", "v"}`` (AdamW) or ``{"step", "vr",
    "vc"}`` (Adafactor), each a parameter-shaped tree of float32 numpy
    arrays."""
    out = {"step": np.asarray(state["step"].cpu(), dtype=np.int32)}
    for key, flat in state.items():
        if key != "step":
            out[key] = nest_paths({p: _whole(t.detach()).float().cpu().numpy().copy()
                                   for p, t in flat.items()})
    return out


def opt_state_from_arrays(tree: dict, device=None) -> dict:
    """The inverse of :func:`opt_state_to_arrays`: leaves (numpy arrays or
    tensors) as float32 tensors on ``device`` (``None``: the card), the
    step as an int32 0-d tensor.  A float32 tensor already on ``device``
    is taken as it is, not copied."""
    from .device import resolve_device

    dev = resolve_device(device)

    def tensor(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    out = {"step": tensor(tree["step"], torch.int32)}
    for key, sub in tree.items():
        if key != "step":
            out[key] = {p: tensor(a, torch.float32)
                        for p, a in flatten_paths(sub).items()}
    return out
