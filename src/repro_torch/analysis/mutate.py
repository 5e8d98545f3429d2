"""Mutation corruptors for the verifier's own test suite (the JAX
package's ``analysis/mutate.py``: the same rng gives the same corrupted
arrays).

Each mutator injects ONE known violation class into a (copied) golden plan
and returns the codes :func:`~repro_torch.analysis.verify_plan` is guaranteed to
raise for it — the fuzz suite then asserts zero false negatives (every
injected corruption flagged with its code) and zero false positives
(golden plans stay clean).  Collateral codes beyond the guaranteed set are
expected: corrupting levels also desynchronises segments, and that is a
real violation too.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.dependency import Levelization, dependencies_exact
from ..core.plan import FactorizePlan
from ..kernels.ref import round_order
from .schedule import host_groups

__all__ = ["MUTATIONS", "mutate_plan", "merge_executor_steps"]

MUTATIONS = (
    "swap_levels",
    "fuse_dependent_pair",
    "scatter_oob",
    "scatter_collision",
    "truncate_reach",
    "corrupt_triple",
    "drop_norm",
)


def _copy_plan(fplan: FactorizePlan) -> FactorizePlan:
    """Independent deep copy: mutations must never leak into the golden
    plan (it is reused across fuzz cases)."""
    kw = {}
    for f in dataclasses.fields(fplan):
        v = getattr(fplan, f.name)
        if isinstance(v, np.ndarray):
            v = v.copy()
        kw[f.name] = v
    kw["levels"] = Levelization(fplan.levels.levels.copy(),
                                fplan.levels.order.copy(),
                                fplan.levels.level_ptr.copy())
    kw["segments"] = [dataclasses.replace(s, cols=np.asarray(s.cols).copy())
                      for s in fplan.segments]
    return FactorizePlan(**kw)


def _relevelize(levels: np.ndarray) -> Levelization:
    order = np.argsort(levels, kind="stable").astype(np.int32)
    nlev = int(levels.max()) + 1 if len(levels) else 0
    counts = np.bincount(levels, minlength=nlev)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return Levelization(levels.astype(np.int32), order, ptr)


def _pick_exact_edge(fplan: FactorizePlan, rng):
    src, dst = dependencies_exact(fplan)
    if not len(src):
        raise ValueError("plan has no dependency edges to corrupt")
    i = int(rng.integers(0, len(src)))
    return int(src[i]), int(dst[i])


def mutate_plan(fplan: FactorizePlan, kind: str, rng):
    """Return ``(mutated_plan, guaranteed_codes, info)`` for one mutation
    class.  ``rng`` is a ``numpy.random.Generator``."""
    p = _copy_plan(fplan)
    info = {}
    if kind == "swap_levels":
        s, d = _pick_exact_edge(p, rng)
        lev = p.levels.levels.astype(np.int64)
        ls, ld = int(lev[s]), int(lev[d])
        lev2 = lev.copy()
        lev2[lev == ls] = ld
        lev2[lev == ld] = ls
        p.levels = _relevelize(lev2)
        info.update(src=s, dst=d)
        return p, frozenset({"RACE_LEVEL_ORDER"}), info
    if kind == "fuse_dependent_pair":
        s, d = _pick_exact_edge(p, rng)
        lev = p.levels.levels.astype(np.int64)
        lev[d] = lev[s]
        p.levels = _relevelize(lev)
        info.update(src=s, dst=d)
        return p, frozenset({"RACE_INTRA_LEVEL"}), info
    if kind == "scatter_oob":
        i = int(rng.integers(0, len(p.a_scatter)))
        p.a_scatter[i] = p.nnz + 3
        info.update(slot=i)
        return p, frozenset({"SCATTER_OOB"}), info
    if kind == "scatter_collision":
        if len(p.a_scatter) < 2:
            raise ValueError("need >= 2 A entries for a collision")
        i = int(rng.integers(1, len(p.a_scatter)))
        p.a_scatter[i] = p.a_scatter[i - 1]
        info.update(slot=i)
        return p, frozenset({"SCATTER_COLLISION"}), info
    if kind == "truncate_reach":
        return _truncate_reach(p, rng, info)
    if kind == "corrupt_triple":
        if not len(p.didx):
            raise ValueError("plan has no update triples")
        i = int(rng.integers(0, len(p.didx)))
        # lidx[i] is a valid in-range entry of the SOURCE column — never
        # the destination column the didx slot must address
        p.didx[i] = p.lidx[i]
        info.update(triple=i)
        return p, frozenset({"TRIPLE_INCONSISTENT"}), info
    if kind == "drop_norm":
        if not len(p.norm_idx):
            raise ValueError("plan has no normalisation entries")
        i = int(rng.integers(0, len(p.norm_idx)))
        p.norm_idx[i] = p.nnz
        info.update(slot=i)
        return p, frozenset({"NORM_OOB"}), info
    raise ValueError(f"unknown mutation {kind!r}; one of {MUTATIONS}")


def _truncate_reach(p: FactorizePlan, rng, info):
    """Drop one L-adjacency entry.  Always REACH_ADJ_MISMATCH; when the
    dropped row is reachable from the seed column ONLY through the dropped
    edge, seeding the closure there also guarantees REACH_UNDER — the
    search below prefers such a column and reports it in ``info``."""
    ptr = p.l_adj_ptr.astype(np.int64)
    counts = np.diff(ptr)
    cands = np.flatnonzero(counts > 0)
    if not len(cands):
        raise ValueError("plan has no L adjacency to truncate")
    indptr = p.indptr.astype(np.int64)
    indices = p.indices.astype(np.int64)

    def l_rows(j):
        s, e = int(indptr[j]), int(indptr[j + 1])
        rows = indices[s:e]
        return rows[rows > j]

    def reachable_without(seed_col, dropped):
        seen = set()
        stack = [int(r) for r in l_rows(seed_col) if r != dropped]
        while stack:
            j = stack.pop()
            if j in seen:
                continue
            seen.add(j)
            stack.extend(int(r) for r in l_rows(j))
        return dropped in seen

    order = rng.permutation(cands)
    col = int(order[0])
    guaranteed = frozenset({"REACH_ADJ_MISMATCH"})
    for j in order.tolist():
        dropped = int(p.l_adj_rows[ptr[j + 1] - 1])
        if not reachable_without(j, dropped):
            col = j
            guaranteed = frozenset({"REACH_ADJ_MISMATCH", "REACH_UNDER"})
            break
    e = int(ptr[col + 1]) - 1
    p.l_adj_rows = np.delete(p.l_adj_rows, e)
    p.l_adj_ptr = ptr.copy()
    p.l_adj_ptr[col + 1:] -= 1
    info.update(seed_col=col, seed_sets=[[col]])
    return p, guaranteed, info


def _adjacent_edge_levels(plan) -> set:
    """Source levels s with an exact dependency edge into level s + 1."""
    src, dst = dependencies_exact(plan)
    lev = np.asarray(plan.levels.levels, dtype=np.int64)
    s, d = lev[src], lev[dst]
    return set(np.unique(s[d == s + 1]).tolist())


def _merge_run_levels(arrs: dict, k: int) -> dict:
    """A K1 run's host arrays with its levels k and k + 1 joined into one
    level (their normalizations, rows and diagonals are contiguous)."""
    out = {key: a.copy() for key, a in arrs.items()}
    lv = out["levels"]
    lv[k, 1], lv[k, 3] = lv[k + 1, 1], lv[k + 1, 3]
    if lv.shape[1] > 5:
        lv[k, 5] = lv[k + 1, 5]
    out["levels"] = np.delete(lv, k + 1, axis=0)
    out["diag_ptr"] = np.delete(out["diag_ptr"], k + 1)
    return out


def _merge_flat(a: dict, b: dict) -> dict:
    """Two flat steps as one: their normalizations and triples together,
    the triples in :func:`round_order` of the destinations again (so the
    rounds stay distinct and only the race is wrong)."""
    cat = {k: np.concatenate([a[k], b[k]])
           for k in ("norm_idx", "norm_diag", "lidx", "uidx", "didx")}
    perm, bounds = round_order(cat["didx"])
    for k in ("lidx", "uidx", "didx"):
        cat[k] = cat[k][perm]
    cat["bounds"] = np.asarray(bounds, dtype=np.int64)
    return cat


def merge_executor_steps(fact):
    """Fuse two dependent adjacent levels of a built factorizer schedule
    into one step: two levels of a K1 run (one grid barrier dropped), or
    two flat steps.  That is the fusion bug ``verify_executor`` exists to
    catch.  The corrupted schedule is built on host arrays
    (:func:`~.schedule.host_groups`), never through ``LevelRun``, whose own
    I1-I3 check would refuse it before the verifier sees it.  Returns
    ``(groups, guaranteed_codes)`` or ``None`` when no two adjacent
    levels of the schedule share an exact dependency edge."""
    adj = _adjacent_edge_levels(fact.plan)
    groups = host_groups(fact)
    level = 0
    for gi, (kind, arrs) in enumerate(groups):
        if kind == "dense":
            break
        if kind == "flat":
            nxt = groups[gi + 1] if gi + 1 < len(groups) else None
            if level in adj and nxt is not None and nxt[0] == "flat":
                merged = ("flat", _merge_flat(arrs, nxt[1]))
                return (groups[:gi] + [merged] + groups[gi + 2:],
                        frozenset({"EXEC_RACE"}))
            level += 1
            continue
        L = len(arrs["levels"])
        for k in range(L - 1):
            if level + k in adj:
                merged = ("run", _merge_run_levels(arrs, k))
                return (groups[:gi] + [merged] + groups[gi + 1:],
                        frozenset({"EXEC_RACE"}))
        level += L
    return None
