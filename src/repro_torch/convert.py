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
values exactly) and the model casts them to ``cfg.dtype``.
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
           "lm_params_from_arrays", "lm_params_to_arrays"]

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


def _flatten(tree, prefix: str, out: dict, index=None):
    """Leaves of nested dicts and lists under dotted names; ``index``
    takes one layer out of scan-stacked leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix[:-1]] = tree if index is None else tree[index]
        return
    for key, sub in items:
        _flatten(sub, f"{prefix}{key}.", out, index)


def _reference_leaves(cfg, tree: dict) -> dict:
    """``{port name: array}`` from the JAX package's parameter tree: each
    group of ``tree["blocks"]`` unstacked into ``layers.<i>``."""
    out: dict = {}
    for key, sub in tree.items():
        if key != "blocks":
            _flatten(sub, f"{key}.", out)
    groups = layer_groups(cfg)
    if len(tree["blocks"]) != len(groups):
        raise ValueError(f"{len(tree['blocks'])} block groups for "
                         f"{len(groups)} of {cfg.name}")
    for g, gp in zip(groups, tree["blocks"]):
        if not g["scan"]:
            for li, i in enumerate(g["indices"]):
                _flatten(gp["layers"][li], f"layers.{i}.", out)
            continue
        for pos in range(g["period"]):
            for r in range(g["repeat"]):
                i = g["start"] + r * g["period"] + pos
                _flatten(gp["pattern"][pos], f"layers.{i}.", out, index=r)
    return out


def lm_params_from_arrays(cfg, tree: dict, device=None):
    """An :class:`LM` on ``device`` (``None``: the card) holding the
    parameters of ``tree``, a parameter tree in the JAX package's layout
    whose leaves are numpy arrays (float32 for bfloat16 weights); each is
    cast to its parameter's dtype.  Every leaf must be there with its
    parameter's shape, and no other."""
    from .models.model import LM
    model = LM(cfg, device)
    leaves = _reference_leaves(cfg, tree)
    params = dict(model.named_parameters())
    if leaves.keys() != params.keys():
        raise KeyError(f"parameter tree of {cfg.name}: missing "
                       f"{sorted(params.keys() - leaves.keys())}, unexpected "
                       f"{sorted(leaves.keys() - params.keys())}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(leaves[name])
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{tuple(p.shape)}")
            if not a.flags.writeable:
                a = a.copy()
            p.copy_(torch.from_numpy(a))
    return model


def lm_params_to_arrays(model) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the JAX package's
    parameter tree (scan groups stacked) of float32 numpy arrays."""
    cfg = model.cfg
    tree: dict = {}
    for name, p in model.named_parameters():
        node, keys = tree, name.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = p.detach().float().cpu().numpy().copy()

    def listed(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return [listed(node[str(i)]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: listed(v) for k, v in node.items()}
        return node

    tree = listed(tree)
    layers = tree.pop("layers")
    blocks = []
    for g in layer_groups(cfg):
        if not g["scan"]:
            blocks.append({"layers": [layers[i] for i in g["indices"]]})
            continue
        period, start = g["period"], g["start"]
        blocks.append({"pattern": [
            _stack([layers[start + r * period + pos] for r in range(g["repeat"])])
            for pos in range(period)]})
    tree["blocks"] = blocks
    return tree


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
