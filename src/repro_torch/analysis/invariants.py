"""Plan-level invariant verification (the JAX package's
``analysis/invariants.py``, on this package's plans).

``verify_plan`` proves a :class:`~repro_torch.core.plan.FactorizePlan` (or the
``SymbolicPlan`` wrapping one) correct *from first principles against the
filled pattern*: every check below recomputes its ground truth directly
from ``(indptr, indices)`` — never from the arrays being checked — so a bug
shared by the planner and the executor cannot hide behind a bit-identity
test between the two.

The race detector is the heart: :func:`repro_torch.core.dependency
.dependencies_exact` rebuilds the column hazard DAG of the
level-synchronous executor (the j -> min(r, k) consumption rule — a strict
subset of the paper's relaxed Alg. 4 superset, a strict superset of the
GLU1.0 U-pattern rule) and every edge must be strictly level-forward.  Any
levelization that passes is a valid schedule; one that fails races on the
real executor semantics, bucket fusion or not.
"""
from __future__ import annotations

import numpy as np

from ..core.dependency import dependencies_exact
from ..sparse.csc import csc_transpose_pattern
from .report import VerifyReport

__all__ = ["verify_plan"]

# triples a chunk of the update-triple check
_CHUNK = 1 << 18


def _as_fplan(plan):
    """(fplan, (a_indptr, a_indices) | None) from a Symbolic- or
    FactorizePlan."""
    if hasattr(plan, "fplan"):  # SymbolicPlan
        return plan.fplan, (plan.perm_indptr, plan.perm_indices)
    return plan, None


def _norm_pattern(pattern):
    if pattern is None:
        return None
    if hasattr(pattern, "indptr"):
        return (np.asarray(pattern.indptr, dtype=np.int64),
                np.asarray(pattern.indices, dtype=np.int64))
    indptr, indices = pattern
    return (np.asarray(indptr, dtype=np.int64),
            np.asarray(indices, dtype=np.int64))


class _Ctx:
    """Shared pattern-derived ground truth for the individual checks."""

    def __init__(self, fplan):
        self.fplan = fplan
        self.n = fplan.n
        self.nnz = len(fplan.indices)
        self.indptr = np.asarray(fplan.indptr, dtype=np.int64)
        self.indices = np.asarray(fplan.indices, dtype=np.int64)
        self.cols_of = np.repeat(np.arange(self.n, dtype=np.int64),
                                 np.diff(self.indptr))
        self.lower = self.indices > self.cols_of
        self.upper = self.indices < self.cols_of
        self.nnz_l = np.bincount(self.cols_of[self.lower],
                                 minlength=self.n).astype(np.int64)
        self.levels = np.asarray(fplan.levels.levels, dtype=np.int64)


def _check_pattern(ctx: _Ctx, rep: VerifyReport) -> bool:
    rep.ran("pattern")
    f = ctx.fplan
    ok = True
    if (len(ctx.indptr) != ctx.n + 1 or ctx.indptr[0] != 0
            or np.any(np.diff(ctx.indptr) < 0)
            or ctx.indptr[-1] != len(ctx.indices)):
        rep.add("PATTERN_MALFORMED", "indptr is not a valid CSC offset array")
        return False
    if f.nnz != len(ctx.indices):
        rep.add("PATTERN_MALFORMED",
                f"plan.nnz={f.nnz} != len(indices)={len(ctx.indices)}")
        ok = False
    if len(ctx.indices) and (ctx.indices.min() < 0
                             or ctx.indices.max() >= ctx.n):
        rep.add("PATTERN_MALFORMED", "row index outside [0, n)")
        return False
    # strictly increasing rows within each column (CSC canonical form —
    # searchsorted-based plan construction and diag lookup assume it)
    same_col = ctx.cols_of[1:] == ctx.cols_of[:-1]
    bad = same_col & (np.diff(ctx.indices) <= 0)
    if np.any(bad):
        i = int(np.flatnonzero(bad)[0])
        rep.add("PATTERN_MALFORMED",
                "rows not strictly increasing within a column",
                col=int(ctx.cols_of[i]), entry=i)
        ok = False
    return ok


def _check_diag(ctx: _Ctx, rep: VerifyReport) -> bool:
    rep.ran("diag")
    di = np.asarray(ctx.fplan.diag_idx, dtype=np.int64)
    if len(di) != ctx.n or np.any(di < 0) or np.any(di >= ctx.nnz):
        rep.add("DIAG_MISMATCH", "diag_idx has wrong length or range")
        return False
    cols = np.arange(ctx.n, dtype=np.int64)
    bad = (ctx.indices[di] != cols) | (ctx.cols_of[di] != cols)
    if np.any(bad):
        j = int(np.flatnonzero(bad)[0])
        rep.add("DIAG_MISMATCH",
                f"diag_idx[{j}] points at "
                f"({int(ctx.indices[di[j]])}, {int(ctx.cols_of[di[j]])})",
                col=j, n_bad=int(bad.sum()))
        return False
    return True


def _check_levels(ctx: _Ctx, rep: VerifyReport) -> bool:
    rep.ran("levels")
    lv = ctx.fplan.levels
    levels = ctx.levels
    order = np.asarray(lv.order, dtype=np.int64)
    ptr = np.asarray(lv.level_ptr, dtype=np.int64)
    if len(levels) != ctx.n or len(order) != ctx.n:
        rep.add("LEVELS_MALFORMED", "levels/order have wrong length")
        return False
    if np.any(np.sort(order) != np.arange(ctx.n)):
        rep.add("LEVELS_MALFORMED", "order is not a permutation of [0, n)")
        return False
    nlev = len(ptr) - 1
    if ctx.n and (levels.min() < 0 or levels.max() != nlev - 1):
        rep.add("LEVELS_MALFORMED",
                f"levels span [{int(levels.min())}, {int(levels.max())}] "
                f"but level_ptr declares {nlev} levels")
        return False
    po = levels[order]
    if np.any(np.diff(po) < 0):
        rep.add("LEVELS_MALFORMED", "order is not grouped by level")
        return False
    expect_ptr = np.searchsorted(po, np.arange(nlev + 1))
    if not np.array_equal(ptr, expect_ptr):
        rep.add("LEVELS_MALFORMED", "level_ptr offsets disagree with levels")
        return False
    return True


def _check_races(ctx: _Ctx, rep: VerifyReport) -> None:
    """Recompute the exact hazard DAG from the pattern; every edge must be
    strictly level-forward.  This validates the *levelization itself* —
    the relaxed detector, the longest-path sweep, and any later level
    rewrite — against the executor's consumption semantics."""
    rep.ran("races")
    src, dst = dependencies_exact(ctx.fplan)
    lev = ctx.levels
    same = lev[src] == lev[dst]
    back = lev[src] > lev[dst]
    if np.any(same):
        idx = np.flatnonzero(same)
        for i in idx[:3]:
            rep.add("RACE_INTRA_LEVEL",
                    f"columns {int(src[i])} -> {int(dst[i])} share level "
                    f"{int(lev[src[i]])}",
                    src=int(src[i]), dst=int(dst[i]),
                    n_bad=int(same.sum()))
    if np.any(back):
        idx = np.flatnonzero(back)
        for i in idx[:3]:
            rep.add("RACE_LEVEL_ORDER",
                    f"edge {int(src[i])} (level {int(lev[src[i]])}) -> "
                    f"{int(dst[i])} (level {int(lev[dst[i]])}) points "
                    "level-backward",
                    src=int(src[i]), dst=int(dst[i]),
                    n_bad=int(back.sum()))


def _check_segments(ctx: _Ctx, rep: VerifyReport) -> bool:
    """Segments partition the norm/update arrays contiguously in level
    order and list exactly the levelization's columns."""
    segs = ctx.fplan.segments
    lv = ctx.fplan.levels
    npos = upos = 0
    ok = True
    for i, seg in enumerate(segs):
        if seg.level != i:
            rep.add("LEVELS_MALFORMED",
                    f"segment {i} carries level {seg.level}")
            ok = False
        if seg.norm_slice.start != npos or seg.upd_slice.start != upos:
            rep.add("LEVELS_MALFORMED",
                    f"segment {i} slices are not contiguous")
            ok = False
        npos, upos = seg.norm_slice.stop, seg.upd_slice.stop
        if i < lv.num_levels and not np.array_equal(
                np.sort(np.asarray(seg.cols)), np.sort(lv.columns_at(i))):
            rep.add("LEVELS_MALFORMED",
                    f"segment {i} columns differ from the levelization's")
            ok = False
    if len(segs) != lv.num_levels:
        rep.add("LEVELS_MALFORMED",
                f"{len(segs)} segments for {lv.num_levels} levels")
        ok = False
    if npos != len(ctx.fplan.norm_idx) or upos != len(ctx.fplan.lidx):
        rep.add("LEVELS_MALFORMED",
                "segment slices do not cover the plan arrays")
        ok = False
    return ok


def _check_norm(ctx: _Ctx, rep: VerifyReport) -> None:
    rep.ran("norm")
    f = ctx.fplan
    ni = np.asarray(f.norm_idx, dtype=np.int64)
    nd = np.asarray(f.norm_diag, dtype=np.int64)
    if len(ni) != len(nd):
        rep.add("NORM_MISMATCH", "norm_idx/norm_diag length mismatch")
        return
    for name, a in (("norm_idx", ni), ("norm_diag", nd)):
        if len(a) and (a.min() < 0 or a.max() >= ctx.nnz):
            rep.add("NORM_OOB", f"{name} outside [0, nnz)",
                    n_bad=int(((a < 0) | (a >= ctx.nnz)).sum()))
            return
    di = np.asarray(f.diag_idx, dtype=np.int64)
    bad = ctx.indices[ni] <= ctx.cols_of[ni]
    if np.any(bad):
        rep.add("NORM_MISMATCH",
                "norm entry not strictly below the diagonal",
                n_bad=int(bad.sum()))
    bad = nd != di[ctx.cols_of[ni]]
    if np.any(bad):
        rep.add("NORM_MISMATCH",
                "norm_diag is not the entry's own column diagonal",
                n_bad=int(bad.sum()))
    low_idx = np.flatnonzero(ctx.lower)
    if not np.array_equal(np.sort(ni), low_idx):
        rep.add("NORM_MISMATCH",
                "normalised entries are not exactly the pattern's L entries",
                got=len(ni), want=len(low_idx))
    # per-level: each segment normalises its own columns' L entries
    for seg in ctx.fplan.segments:
        got = np.sort(ctx.cols_of[ni[seg.norm_slice]])
        want = np.sort(np.repeat(np.asarray(seg.cols, dtype=np.int64),
                                 ctx.nnz_l[seg.cols]))
        if not np.array_equal(got, want):
            rep.add("NORM_MISMATCH",
                    f"level {seg.level} normalises the wrong columns",
                    level=seg.level)
            break


def _check_triples(ctx: _Ctx, rep: VerifyReport) -> None:
    rep.ran("triples")
    f = ctx.fplan
    li = np.asarray(f.lidx, dtype=np.int64)
    ui = np.asarray(f.uidx, dtype=np.int64)
    di = np.asarray(f.didx, dtype=np.int64)
    dc = np.asarray(f.dst_col, dtype=np.int64)
    if not (len(li) == len(ui) == len(di) == len(dc)):
        rep.add("TRIPLE_INCONSISTENT", "triple arrays have unequal lengths")
        return
    for name, a, hi in (("lidx", li, ctx.nnz), ("uidx", ui, ctx.nnz),
                        ("didx", di, ctx.nnz), ("dst_col", dc, ctx.n)):
        if len(a) and (a.min() < 0 or a.max() >= hi):
            rep.add("TRIPLE_OOB", f"{name} outside [0, {hi})",
                    n_bad=int(((a < 0) | (a >= hi)).sum()))
            return
    rows, cols = ctx.indices, ctx.cols_of
    # one relational pass pins every triple to the factorization update
    # vals[(r, k)] -= vals[(r, j)] * vals[(j, k)] with r > j, k > j; run
    # in chunks of triples (a plan's dense tail holds most of them:
    # rajat12_like 132.5 M), so the temporaries stay small
    n_bad = np.zeros(5, dtype=np.int64)
    first_didx = None
    order_ok, prev = True, None
    for s in range(0, len(li), _CHUNK):
        l, u, d, c = (a[s:s + _CHUNK] for a in (li, ui, di, dc))
        cl, rl, ru, cu = cols[l], rows[l], rows[u], cols[u]
        bad_d = (rows[d] != rl) | (cols[d] != c)
        n_bad += [np.count_nonzero(cl >= rl), np.count_nonzero(ru != cl),
                  np.count_nonzero(cu <= ru), np.count_nonzero(c != cu),
                  np.count_nonzero(bad_d)]
        if first_didx is None and bad_d.any():
            first_didx = s + int(np.flatnonzero(bad_d)[0])
        okey = ctx.levels[cl] * ctx.n + c
        if np.any(np.diff(okey) < 0) or (prev is not None and okey[0] < prev):
            order_ok = False
        prev = okey[-1]
    for k, msg in enumerate(("lidx is not a strict L entry",
                             "uidx row is not the triple's source column",
                             "uidx is not a strict U entry",
                             "dst_col differs from uidx's column")):
        if n_bad[k]:
            rep.add("TRIPLE_INCONSISTENT", msg, n_bad=int(n_bad[k]))
    if n_bad[4]:
        rep.add("TRIPLE_INCONSISTENT",
                "didx does not address (row(lidx), dst_col)",
                triple=first_didx, n_bad=int(n_bad[4]))
    # completeness: the consistency pass shows every triple IS a valid
    # update; exact count + (lidx, uidx) uniqueness then pigeonhole the
    # multiset to exactly { (L entry of j) x (U-row entry of j) : all j }
    indptr_t, indices_t, _ = csc_transpose_pattern(
        ctx.n, ctx.fplan.indptr, ctx.fplan.indices)
    rws = np.repeat(np.arange(ctx.n, dtype=np.int64), np.diff(indptr_t))
    n_up_row = np.bincount(rws[np.asarray(indices_t, dtype=np.int64) > rws],
                           minlength=ctx.n).astype(np.int64)
    want = int((ctx.nnz_l * n_up_row).sum())
    if len(li) != want:
        rep.add("TRIPLE_SET_MISMATCH",
                f"{len(li)} update triples, pattern requires {want}")
    key = li * ctx.nnz + ui
    key.sort()
    if np.any(key[1:] == key[:-1]):
        rep.add("TRIPLE_SET_MISMATCH", "duplicate (lidx, uidx) pair")
    del key
    # order: sorted by (source level, destination column) — the segmented
    # executor layouts assume contiguous per-destination runs per level
    if not order_ok:
        rep.add("TRIPLE_ORDER",
                "triples not sorted by (level, destination column)")
    for seg in ctx.fplan.segments:
        if not np.all(ctx.levels[cols[li[seg.upd_slice]]] == seg.level):
            rep.add("TRIPLE_ORDER",
                    f"level-{seg.level} segment contains foreign triples",
                    level=seg.level)
            break


def _check_scatter(ctx: _Ctx, rep: VerifyReport, a_pattern) -> None:
    rep.ran("scatter")
    asc = np.asarray(ctx.fplan.a_scatter, dtype=np.int64)
    if len(asc) and (asc.min() < 0 or asc.max() >= ctx.nnz):
        rep.add("SCATTER_OOB", "a_scatter outside [0, nnz)",
                n_bad=int(((asc < 0) | (asc >= ctx.nnz)).sum()))
        return
    uniq, counts = np.unique(asc, return_counts=True)
    if np.any(counts > 1):
        s = int(uniq[np.argmax(counts)])
        rep.add("SCATTER_COLLISION",
                f"{int((counts > 1).sum())} filled slot(s) receive multiple "
                "A entries", slot=s)
    if a_pattern is None:
        return
    a_indptr, a_indices = a_pattern
    a_cols = np.repeat(np.arange(len(a_indptr) - 1, dtype=np.int64),
                       np.diff(a_indptr))
    if len(asc) != len(a_indices):
        rep.add("SCATTER_MISMATCH",
                f"{len(asc)} scatter slots for {len(a_indices)} A entries")
        return
    bad = (ctx.indices[asc] != a_indices) | (ctx.cols_of[asc] != a_cols)
    if np.any(bad):
        i = int(np.flatnonzero(bad)[0])
        rep.add("SCATTER_MISMATCH",
                "a_scatter target coordinates differ from A's",
                entry=i, n_bad=int(bad.sum()))


def _check_trisolve_fwd(ctx: _Ctx, rep: VerifyReport) -> None:
    rep.ran("trisolve_fwd")
    f = ctx.fplan
    fr = np.asarray(f.fwd_rows, dtype=np.int64)
    fc = np.asarray(f.fwd_cols, dtype=np.int64)
    fv = np.asarray(f.fwd_vidx, dtype=np.int64)
    ptr = np.asarray(f.fwd_ptr, dtype=np.int64)
    if len(fv) and (fv.min() < 0 or fv.max() >= ctx.nnz):
        rep.add("TRISOLVE_FWD_SET", "fwd_vidx outside [0, nnz)")
        return
    bad = (ctx.indices[fv] != fr) | (ctx.cols_of[fv] != fc) | (fr <= fc)
    if np.any(bad):
        rep.add("TRISOLVE_FWD_SET",
                "fwd rows/cols disagree with the L entries they index",
                n_bad=int(bad.sum()))
    if not np.array_equal(np.sort(fv), np.flatnonzero(ctx.lower)):
        rep.add("TRISOLVE_FWD_SET",
                "forward schedule is not exactly the pattern's L entries",
                got=len(fv), want=int(ctx.lower.sum()))
    if (ptr[0] != 0 or ptr[-1] != len(fv) or np.any(np.diff(ptr) < 0)):
        rep.add("TRISOLVE_FWD_SET", "fwd_ptr is not a valid offset array")
        return
    # step-timing happens-before: entry (r, c) at step t reads x[c] (the
    # gather sees pre-step state) and writes x[r]; every write into a
    # column must land strictly before that column's first read
    step = np.searchsorted(ptr, np.arange(len(fv)), side="right") - 1
    wmax = np.full(ctx.n, -1, dtype=np.int64)
    np.maximum.at(wmax, fr, step)
    rmin = np.full(ctx.n, len(ptr), dtype=np.int64)
    np.minimum.at(rmin, fc, step)
    bad = wmax >= rmin
    if np.any(bad):
        c = int(np.flatnonzero(bad)[0])
        rep.add("TRISOLVE_FWD_RACE",
                f"x[{c}] is written at step {int(wmax[c])} but read at "
                f"step {int(rmin[c])}",
                col=c, n_bad=int(bad.sum()))


def _check_trisolve_bwd(ctx: _Ctx, rep: VerifyReport) -> None:
    rep.ran("trisolve_bwd")
    f = ctx.fplan
    br = np.asarray(f.bwd_rows, dtype=np.int64)
    bc = np.asarray(f.bwd_cols, dtype=np.int64)
    bv = np.asarray(f.bwd_vidx, dtype=np.int64)
    ptr = np.asarray(f.bwd_ptr, dtype=np.int64)
    blc = np.asarray(f.bwd_level_cols, dtype=np.int64)
    cptr = np.asarray(f.bwd_col_ptr, dtype=np.int64)
    if not np.array_equal(np.sort(blc), np.arange(ctx.n)):
        rep.add("TRISOLVE_BWD_SET",
                "bwd_level_cols is not a permutation of [0, n) — some "
                "column is divided twice or never")
        return
    if (cptr[0] != 0 or cptr[-1] != ctx.n or np.any(np.diff(cptr) < 0)
            or len(cptr) != len(ptr)):
        rep.add("TRISOLVE_BWD_SET", "bwd_col_ptr is not a valid offset array")
        return
    if len(bv) and (bv.min() < 0 or bv.max() >= ctx.nnz):
        rep.add("TRISOLVE_BWD_SET", "bwd_vidx outside [0, nnz)")
        return
    bad = (ctx.indices[bv] != br) | (ctx.cols_of[bv] != bc) | (br >= bc)
    if np.any(bad):
        rep.add("TRISOLVE_BWD_SET",
                "bwd rows/cols disagree with the U entries they index",
                n_bad=int(bad.sum()))
    if not np.array_equal(np.sort(bv), np.flatnonzero(ctx.upper)):
        rep.add("TRISOLVE_BWD_SET",
                "backward schedule is not exactly the pattern's strict "
                "U entries", got=len(bv), want=int(ctx.upper.sum()))
    if (ptr[0] != 0 or ptr[-1] != len(bv) or np.any(np.diff(ptr) < 0)):
        rep.add("TRISOLVE_BWD_SET", "bwd_ptr is not a valid offset array")
        return
    # step timing: step t first divides x[c] for its level columns, THEN
    # applies its updates (sequential inside the traced step body).  An
    # update (r, c) at step t therefore needs x[c] divided at a step <= t
    # and must land strictly before x[r]'s division.
    t_div = np.empty(ctx.n, dtype=np.int64)
    t_div[blc] = np.searchsorted(cptr, np.arange(ctx.n), side="right") - 1
    t_e = np.searchsorted(ptr, np.arange(len(bv)), side="right") - 1
    bad = (t_div[bc] > t_e) | (t_e >= t_div[br])
    if np.any(bad):
        i = int(np.flatnonzero(bad)[0])
        rep.add("TRISOLVE_BWD_RACE",
                f"update ({int(br[i])}, {int(bc[i])}) at step {int(t_e[i])} "
                f"races divisions at steps {int(t_div[br[i]])} (row) / "
                f"{int(t_div[bc[i]])} (col)",
                entry=i, n_bad=int(bad.sum()))


def _reach_reference(ctx: _Ctx, seeds, direction: str) -> np.ndarray:
    """Independent Python-set BFS on the pattern itself (no plan arrays)."""
    visited = set(int(s) for s in np.asarray(seeds).ravel())
    stack = list(visited)
    while stack:
        j = stack.pop()
        s, e = int(ctx.indptr[j]), int(ctx.indptr[j + 1])
        rows = ctx.indices[s:e]
        nbrs = rows[rows > j] if direction == "fwd" else rows[rows < j]
        for r in nbrs.tolist():
            if r not in visited:
                visited.add(r)
                stack.append(r)
    return np.asarray(sorted(visited), dtype=np.int64)


def _check_reach(ctx: _Ctx, rep: VerifyReport, trials: int, seed: int,
                 seed_sets) -> None:
    rep.ran("reach")
    f = ctx.fplan
    # structural: the plan's DAG adjacency must be the pattern's, column
    # major — a truncated/shifted adjacency under-approximates closures
    want_ptr = np.concatenate([[0], np.cumsum(ctx.nnz_l)])
    if not (np.array_equal(np.asarray(f.l_adj_ptr, dtype=np.int64), want_ptr)
            and np.array_equal(np.asarray(f.l_adj_rows, dtype=np.int64),
                               ctx.indices[ctx.lower])):
        rep.add("REACH_ADJ_MISMATCH",
                "L adjacency differs from the pattern's below-diagonal rows")
    nnz_u = np.bincount(ctx.cols_of[ctx.upper],
                        minlength=ctx.n).astype(np.int64)
    want_ptr = np.concatenate([[0], np.cumsum(nnz_u)])
    if not (np.array_equal(np.asarray(f.u_adj_ptr, dtype=np.int64), want_ptr)
            and np.array_equal(np.asarray(f.u_adj_rows, dtype=np.int64),
                               ctx.indices[ctx.upper])):
        rep.add("REACH_ADJ_MISMATCH",
                "U adjacency differs from the pattern's above-diagonal rows")
    if seed_sets is None:
        rng = np.random.default_rng(seed)
        seed_sets = [rng.integers(0, ctx.n, size=int(rng.integers(1, 4)))
                     for _ in range(trials)] if ctx.n else []
    for seeds in seed_sets:
        seeds = np.asarray(seeds, dtype=np.int64)
        for direction, fn in (("fwd", f.fwd_reach), ("bwd", f.bwd_reach)):
            got = np.asarray(fn(seeds), dtype=np.int64)
            ref = _reach_reference(ctx, seeds, direction)
            missing = np.setdiff1d(ref, got)
            extra = np.setdiff1d(got, ref)
            if missing.size:
                rep.add("REACH_UNDER",
                        f"{direction} reach of {seeds.tolist()} misses "
                        f"{missing.size} column(s)",
                        first=int(missing[0]))
            if extra.size:
                rep.add("REACH_OVER",
                        f"{direction} reach of {seeds.tolist()} includes "
                        f"{extra.size} unreachable column(s)",
                        first=int(extra[0]))


def verify_plan(plan, pattern=None, *, reach_trials: int = 8, seed: int = 0,
                reach_seed_sets=None) -> VerifyReport:
    """Verify a plan against the matrix pattern it claims to schedule.

    Parameters
    ----------
    plan: :class:`~repro_torch.core.planner.SymbolicPlan` or
        :class:`~repro_torch.core.plan.FactorizePlan` (or any object with
        their fields: the JAX package's plans verify too).
    pattern: optional original (pre-fill) A pattern — anything with
        ``.indptr``/``.indices`` or an ``(indptr, indices)`` tuple — used to
        pin the ``a_scatter`` coordinates.  A ``SymbolicPlan`` supplies its
        own permuted pattern; without one the scatter check still proves
        bounds and injectivity.
    reach_trials / seed / reach_seed_sets: random seed sets for the
        closure-soundness trials (explicit ``reach_seed_sets`` overrides
        the random draw — mutation tests aim them at known columns).

    Returns a :class:`VerifyReport`; it never raises — callers choose via
    ``report.raise_if_violated()``.
    """
    fplan, a_pattern = _as_fplan(plan)
    if pattern is not None:
        a_pattern = _norm_pattern(pattern)
    rep = VerifyReport()
    ctx = _Ctx(fplan)
    if not _check_pattern(ctx, rep):
        return rep          # nothing else can be trusted to even index
    diag_ok = _check_diag(ctx, rep)
    levels_ok = _check_levels(ctx, rep)
    if levels_ok:
        _check_races(ctx, rep)
        _check_segments(ctx, rep)
    if diag_ok:
        _check_norm(ctx, rep)
        _check_triples(ctx, rep)
    _check_scatter(ctx, rep, a_pattern)
    _check_trisolve_fwd(ctx, rep)
    _check_trisolve_bwd(ctx, rep)
    _check_reach(ctx, rep, reach_trials, seed, reach_seed_sets)
    return rep
