"""Carry a plan across packages as plain numpy arrays.

A plan plays the part that weights play in a model: ``plan_to_arrays``
reads any object with the fields of a ``FactorizePlan`` (or of a
``SymbolicPlan``, whose factorize plan sits in ``fplan``) into a flat dict
of numpy arrays, ints and strings, and ``plan_from_arrays`` /
``symbolic_plan_from_arrays`` build this package's plans from such a dict.
So a plan made by the JAX package's planner can drive this package's
executors, which holds the numerics apart from the planner.
"""
from __future__ import annotations

import numpy as np

from .core.dependency import Levelization
from .core.plan import FactorizePlan, LevelSegment
from .core.planner import SymbolicPlan
from .core.symbolic import FilledPattern

__all__ = ["plan_to_arrays", "plan_from_arrays", "symbolic_plan_from_arrays"]

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
