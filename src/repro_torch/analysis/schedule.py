"""Executed-schedule verification: the steps the executor really runs.

``verify_plan`` proves the *plan* is a valid schedule; this module proves
the *executor actually built that schedule* (the JAX package's
``analysis/schedule.py``, on this package's steps).  The factorizer turns
the plan into three kinds of step (``core/factorize.py``, ``_Schedule``):
a flat level (its normalizations, then its update triples in fixed-order
rounds of distinct destinations), a run of consecutive K1 levels (one
packed ``LevelRun`` layout, one grid barrier a level) and the dense
trailing block (position lists into one dense tile).  A bug in any of
these rewrites (a run that joins a producer level with its consumer, a
round with a repeated target, a tail list that misses an entry) would race
or drop work while every plan-level check still passes.

The walk reads host copies of the device index tensors (so it runs on a
schedule built on the card too), unpacks every step into per-level steps,
and applies the JAX package's write/read timing model: a level first
normalises (time ``2t``: gathers read pre-step state, then the set lands),
then applies its update triples (time ``2t + 1``: l/u gathers read, the
scatter-add writes).  For every entry the max update-write time must be
strictly below the min consuming-read time.  A K1 level is modelled the
same way: the kernel divides each L operand by its column diagonal inside
the product and writes the normalized L entries after the run's last
level, which the run invariants I1-I3 make equal to the model (they are
checked here on the run's layout as executed, under the port's own code
``EXEC_RUN_INVARIANT``).  Flat levels and sweep levels must keep their
rounds' targets distinct (``EXEC_ROUND_TARGETS``): that is what makes each
round's ``index_add_`` exact and fixed in order.

:func:`verify_trisolver` walks the forward and backward sweeps the same
way: the full sweeps, and on request the pruned sweeps of one right-hand
side pattern against its reach.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.level_update import check_run_invariants
from .report import VerifyReport

__all__ = ["host_groups", "sweep_levels", "verify_executor",
           "verify_trisolver"]

_BIG = 1 << 40


def _np(a) -> np.ndarray:
    """A host int64 copy of an index tensor or array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).astype(np.int64)


def host_groups(fact) -> list:
    """The factorizer's built steps as host arrays, one ``(kind, arrays)``
    per step: ``("flat", dict(norm_idx, norm_diag, lidx, uidx, didx,
    bounds))``, ``("run", dict(levels, rows, upd, norm, diag_ptr, diag))``
    (the ``LevelRun`` tensors the kernel reads) and ``("dense",
    dict(tail_vidx, tail_flat, eye_flat, Np))``."""
    out = []
    for g in fact._groups:
        if g.kind == "flat":
            names = ("norm_idx", "norm_diag", "lidx", "uidx", "didx")
            arrs = {k: _np(a) for k, a in zip(names, g.arrays[:5])}
            arrs["bounds"] = _np(g.arrays[5])
        elif g.kind == "run":
            t = g.arrays[0].tensors
            arrs = {k: _np(t[k]) for k in ("levels", "rows", "upd", "norm",
                                           "diag_ptr", "diag")}
        else:
            tv, tf, ef, Np = g.arrays
            arrs = dict(tail_vidx=_np(tv), tail_flat=_np(tf),
                        eye_flat=_np(ef), Np=int(Np))
        out.append((g.kind, arrs))
    return out


def _check_rounds(targets, bounds, rep, where, **ctx) -> None:
    """Rounds ``bounds`` tile the entries and each holds distinct targets."""
    b = np.asarray(bounds, dtype=np.int64)
    if (len(b) < 1 or b[0] != 0 or b[-1] != len(targets)
            or np.any(np.diff(b) < 0)):
        rep.add("EXEC_ROUND_TARGETS",
                f"{where}: round bounds do not tile its entries", **ctx)
        return
    rnd = np.repeat(np.arange(len(b) - 1), np.diff(b))
    key = np.unique(rnd * (int(targets.max(initial=0)) + 1) + targets)
    if len(key) != len(targets):
        rep.add("EXEC_ROUND_TARGETS",
                f"{where}: a round writes one target twice",
                n_dup=int(len(targets) - len(key)), **ctx)


def _run_levels(arrs, nnz, gi, rep):
    """Per-level steps of one K1 run, after its invariants I1-I3 and its
    bounds: (norm_idx, norm_diag, lidx, uidx, didx, ldiag) each."""
    levels, rows, upd, norm = (arrs[k] for k in ("levels", "rows", "upd",
                                                 "norm"))
    if (rows.size and (rows.min() < 0 or (rows[:, 0] + rows[:, 1]).max()
                       > nnz)) or (upd.size and (
            upd[:, :3].min() < 0 or upd[:, :3].max() > nnz
            or upd[:, 3].min() < 0)) or (norm.size and (
            norm.min() < 0 or norm.max() > nnz)):
        rep.add("EXEC_PAD_OOB", "K1 run index outside [0, nnz]", group=gi)
        return []
    try:
        check_run_invariants(levels, rows, upd, norm,
                             (arrs["diag_ptr"], arrs["diag"]))
    except (ValueError, IndexError) as e:
        rep.add("EXEC_RUN_INVARIANT", f"K1 run {gi}: {e}", group=gi)
    row_of = np.repeat(np.arange(len(rows)), rows[:, 3] - rows[:, 2])
    if np.any(upd[:, 3] >= rows[row_of, 1]):
        rep.add("EXEC_PAD_OOB", "K1 update position outside its segment",
                group=gi)
    slot = rows[row_of, 0] + upd[:, 3]
    steps = []
    for n0, n1, r0, r1 in levels[:, :4]:
        u0, u1 = rows[r0, 2], rows[r1 - 1, 3]
        steps.append((norm[n0:n1, 0], norm[n0:n1, 1], upd[u0:u1, 0],
                      upd[u0:u1, 1], slot[u0:u1], upd[u0:u1, 2]))
    return steps


def _steps_from_groups(groups, nnz, rep):
    """Flatten executor steps into per-level (ni, nd, li, ui, di, ldiag)
    int64 tuples; returns (steps, dense arrays or None)."""
    steps = []
    dense = None
    empty = np.zeros(0, dtype=np.int64)
    for gi, (kind, arrs) in enumerate(groups):
        if kind == "dense":
            if gi != len(groups) - 1:
                rep.add("EXEC_DENSE_TAIL",
                        f"dense group at position {gi} is not last")
            dense = arrs
        elif kind == "flat":
            _check_rounds(arrs["didx"], arrs["bounds"], rep,
                          f"flat step {gi}", group=gi)
            steps.append((arrs["norm_idx"], arrs["norm_diag"], arrs["lidx"],
                          arrs["uidx"], arrs["didx"], empty))
        elif kind == "run":
            steps += _run_levels(arrs, nnz, gi, rep)
        else:
            rep.add("EXEC_PAD_OOB", f"unknown group kind {kind!r}", group=gi)
    return steps, dense


def verify_executor(fact, *, groups=None) -> VerifyReport:
    """Verify a built :class:`~repro_torch.core.factorize.TorchFactorizer`
    schedule against its plan.  ``groups`` (as :func:`host_groups` gives
    them) overrides the factorizer's own: the mutation tests feed corrupted
    schedules through a golden factorizer."""
    plan = fact.plan
    nnz = plan.nnz
    rep = VerifyReport()
    rep.ran("exec_schedule")
    groups = host_groups(fact) if groups is None else list(groups)
    steps, dense = _steps_from_groups(groups, nnz, rep)

    info = fact.dense_tail_info
    level_cut = plan.num_levels if info is None else info["level_cut"]
    if (dense is None) != (info is None):
        rep.add("EXEC_DENSE_TAIL",
                "dense group and dense_tail_info disagree on existence")
        return rep

    indptr = np.asarray(plan.indptr, dtype=np.int64)
    indices = np.asarray(plan.indices, dtype=np.int64)
    cols_of = np.repeat(np.arange(plan.n, dtype=np.int64), np.diff(indptr))
    diag_idx = np.asarray(plan.diag_idx, dtype=np.int64)

    # slot nnz is the executor's trash slot; one extra slot absorbs it so
    # the timing scatters below never special-case it
    wmax = np.full(nnz + 1, -_BIG, dtype=np.int64)
    rmin = np.full(nnz + 1, _BIG, dtype=np.int64)
    nwrite = np.full(nnz + 1, -1, dtype=np.int64)
    exec_norms, exec_ndiag = [], []
    exec_li, exec_ui, exec_di, exec_t = [], [], [], []

    for t, (ni, nd, li, ui, di, ld) in enumerate(steps):
        for name, a in (("norm_idx", ni), ("norm_diag", nd), ("lidx", li),
                        ("uidx", ui), ("didx", di), ("ldiag", ld)):
            if len(a) and (a.min() < 0 or a.max() > nnz):
                rep.add("EXEC_PAD_OOB", f"{name} outside [0, nnz]", step=t)
                return rep
        m = ni != nnz
        if np.any(nd[m] == nnz):
            rep.add("EXEC_PAD_OOB",
                    "norm entry with padded diagonal slot", step=t)
        nmv = ni[m]
        nwrite[nmv] = 2 * t
        np.minimum.at(rmin, nmv, 2 * t)      # the norm's own gather
        np.minimum.at(rmin, nd[m], 2 * t)    # the diagonal read
        exec_norms.append(nmv)
        exec_ndiag.append(nd[m])
        mu = (li != nnz) & (ui != nnz) & (di != nnz)
        mixed = (li != nnz) | (ui != nnz) | (di != nnz)
        if np.any(mixed & ~mu):
            rep.add("EXEC_PAD_OOB", "partially padded update triple", step=t)
        np.minimum.at(rmin, li[mu], 2 * t + 1)
        np.minimum.at(rmin, ui[mu], 2 * t + 1)
        np.maximum.at(wmax, di[mu], 2 * t + 1)
        if len(ld):
            # a K1 update divides its L operand by that column's diagonal
            np.minimum.at(rmin, ld[mu], 2 * t + 1)
            if np.any(ld[mu] != diag_idx[cols_of[li[mu]]]):
                rep.add("EXEC_UPDATE_COVERAGE",
                        "K1 update divides its L operand by another "
                        "column's diagonal", step=t)
        exec_li.append(li[mu])
        exec_ui.append(ui[mu])
        exec_di.append(di[mu])
        exec_t.append(np.full(int(mu.sum()), t, dtype=np.int64))

    T = len(steps)
    if dense is not None:
        # the dense step gathers every trailing-block entry at its start
        c_star = info["c_star"]
        m = (indices >= c_star) & (cols_of >= c_star)
        np.minimum.at(rmin, np.flatnonzero(m), 2 * T)

    bad = wmax[:nnz] >= rmin[:nnz]
    if np.any(bad):
        e = int(np.flatnonzero(bad)[0])
        rep.add("EXEC_RACE",
                f"entry {e} ({int(indices[e])}, {int(cols_of[e])}) is "
                f"written at time {int(wmax[e])} but read at time "
                f"{int(rmin[e])}",
                entry=e, n_bad=int(bad.sum()))

    if exec_li:
        li = np.concatenate(exec_li)
        ui = np.concatenate(exec_ui)
        di = np.concatenate(exec_di)
        ts = np.concatenate(exec_t)
        bad = nwrite[li] > 2 * ts + 1
        never = nwrite[li] < 0
        if np.any(bad | never):
            i = int(np.flatnonzero(bad | never)[0])
            rep.add("EXEC_SOURCE_ORDER",
                    f"update at step {int(ts[i])} consumes entry "
                    f"{int(li[i])} normalised at time {int(nwrite[li[i]])}",
                    n_bad=int((bad | never).sum()))
    else:
        li = ui = di = np.zeros(0, dtype=np.int64)

    # coverage: the sparse steps must execute EXACTLY the plan's pre-cut
    # normalisations and triples (each once; the dense block owns the rest)
    norm_end = upd_end = 0
    if level_cut > 0 and plan.segments:
        last = plan.segments[min(level_cut, len(plan.segments)) - 1]
        norm_end = last.norm_slice.stop
        upd_end = last.upd_slice.stop
    got_n = (np.sort(np.concatenate(exec_norms)) if exec_norms
             else np.zeros(0, dtype=np.int64))
    want_n = np.sort(np.asarray(plan.norm_idx[:norm_end], dtype=np.int64))
    if not np.array_equal(got_n, want_n):
        rep.add("EXEC_NORM_COVERAGE",
                "executed normalisations differ from the plan's",
                got=len(got_n), want=len(want_n))
    nd_all = (np.concatenate(exec_ndiag) if exec_ndiag
              else np.zeros(0, dtype=np.int64))
    ni_all = (np.concatenate(exec_norms) if exec_norms
              else np.zeros(0, dtype=np.int64))
    if np.any(nd_all != diag_idx[cols_of[ni_all]]):
        rep.add("EXEC_NORM_COVERAGE",
                "executed norm diagonal is not the entry's column diagonal")
    key = li * (nnz + 1) + ui
    order = np.argsort(key, kind="stable")
    pli = np.asarray(plan.lidx[:upd_end], dtype=np.int64)
    pui = np.asarray(plan.uidx[:upd_end], dtype=np.int64)
    pdi = np.asarray(plan.didx[:upd_end], dtype=np.int64)
    pkey = pli * (nnz + 1) + pui
    porder = np.argsort(pkey, kind="stable")
    if not (len(key) == len(pkey)
            and np.array_equal(key[order], pkey[porder])
            and np.array_equal(di[order], pdi[porder])):
        rep.add("EXEC_UPDATE_COVERAGE",
                "executed update triples differ from the plan's",
                got=len(key), want=len(pkey))

    if dense is not None:
        rep.ran("dense_tail")
        _check_dense(plan, info, dense, level_cut, indices, cols_of, rep)
    return rep


def _check_dense(plan, info, dense, level_cut, indices, cols_of, rep):
    """The tail's position lists against the ground truth rebuilt from the
    pattern: every entry of the trailing block [c*, n) gathered once into
    its place of the row-major (Np, Np) tile, ones on the padded diagonal
    only (the JAX package's ``_dense_tail_want``, as lists)."""
    c_star, Np, size = info["c_star"], dense["Np"], info["size"]
    levels = np.asarray(plan.levels.levels, dtype=np.int64)
    if not np.array_equal(np.flatnonzero(levels >= level_cut),
                          np.arange(c_star, plan.n)):
        rep.add("EXEC_DENSE_TAIL",
                "columns at levels >= level_cut are not exactly "
                f"[{c_star}, n)")
    if size != plan.n - c_star or Np < size or info["padded"] != Np:
        rep.add("EXEC_DENSE_TAIL", "dense tile has the wrong size")
        return
    m = (indices >= c_star) & (cols_of >= c_star)
    want_v = np.flatnonzero(m)
    want_f = (indices[m] - c_star) * Np + (cols_of[m] - c_star)
    tv, tf = dense["tail_vidx"], dense["tail_flat"]
    o = np.argsort(tv, kind="stable")
    if not (len(tv) == len(tf) == len(want_v)
            and np.array_equal(tv[o], want_v)
            and np.array_equal(tf[o], want_f)):
        rep.add("EXEC_DENSE_TAIL",
                "dense position lists disagree with the pattern",
                got=len(tv), want=len(want_v))
    want_eye = np.arange(size, Np, dtype=np.int64) * (Np + 1)
    if not np.array_equal(np.sort(dense["eye_flat"]), want_eye):
        rep.add("EXEC_DENSE_TAIL", "padded-diagonal positions are wrong")


def sweep_levels(levels) -> list:
    """Host int64 copies of sweep levels: each level a tuple of index
    tensors with its round bounds last (``_Sweeps.fwd`` / ``.bwd``)."""
    return [tuple(_np(a) for a in lev[:-1]) + (_np(lev[-1]),)
            for lev in levels]


def _reach(plan, seeds, direction: str) -> np.ndarray:
    """Independent Python-set closure on the pattern itself (no plan
    arrays): ``fwd`` follows L's below-diagonal rows, ``bwd`` U's
    above-diagonal ones."""
    indptr = np.asarray(plan.indptr, dtype=np.int64)
    indices = np.asarray(plan.indices, dtype=np.int64)
    visited = set(int(s) for s in np.asarray(seeds).ravel())
    stack = list(visited)
    while stack:
        j = stack.pop()
        rows = indices[indptr[j]:indptr[j + 1]]
        for r in (rows[rows > j] if direction == "fwd"
                  else rows[rows < j]).tolist():
            if r not in visited:
                visited.add(r)
                stack.append(r)
    return np.asarray(sorted(visited), dtype=np.int64)


def verify_trisolver(solver, *, fwd_levels=None, bwd_levels=None,
                     rhs_pattern=None) -> VerifyReport:
    """Verify a built :class:`~repro_torch.core.triangular.TorchTriangularSolver`
    schedule against its plan (the step-timing discipline of
    :func:`verify_executor`, on the solution vector instead of the value
    array).  Without ``rhs_pattern`` the full sweeps must execute exactly
    L's and U's entries; with one, the pruned sweeps of
    ``schedule_for_pattern(rhs_pattern)`` must execute exactly the entries
    whose source column lies in the pattern's reach, and the reaches must
    equal closures computed from the pattern.  ``fwd_levels`` /
    ``bwd_levels`` override the solver's levels (the mutation tests)."""
    plan = solver.plan
    n, nnz = plan.n, plan.nnz
    rep = VerifyReport()
    indptr = np.asarray(plan.indptr, dtype=np.int64)
    indices = np.asarray(plan.indices, dtype=np.int64)
    cols_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag_idx = np.asarray(plan.diag_idx, dtype=np.int64)
    fmask = np.ones(n + 1, dtype=bool)
    bmask = np.ones(n + 1, dtype=bool)
    if rhs_pattern is None:
        rep.ran("trisolve_schedule")
        fl, bl = solver.fwd_levels, solver.bwd_levels
    else:
        rep.ran("trisolve_schedule_pruned")
        fl, bl, freach, breach = solver.schedule_for_pattern(rhs_pattern)
        want_f = _reach(plan, rhs_pattern, "fwd")
        want_b = _reach(plan, want_f, "bwd")
        for got, want, d in ((freach, want_f, "fwd"), (breach, want_b, "bwd")):
            got = np.asarray(got, dtype=np.int64)
            if np.setdiff1d(want, got).size:
                rep.add("REACH_UNDER", f"pruned {d} reach misses columns")
            if np.setdiff1d(got, want).size:
                rep.add("REACH_OVER", f"pruned {d} reach has extra columns")
        fmask[:] = False
        fmask[want_f] = True
        bmask[:] = False
        bmask[want_b] = True
    fl = sweep_levels(fl if fwd_levels is None else fwd_levels)
    bl = sweep_levels(bl if bwd_levels is None else bwd_levels)
    lower = (indices > cols_of) & fmask[cols_of]
    upper = (indices < cols_of) & bmask[cols_of]

    # forward sweep: step t reads x[cols] (pre-step) and adds into x[rows]
    wmax = np.full(n + 1, -_BIG, dtype=np.int64)
    rmin = np.full(n + 1, _BIG, dtype=np.int64)
    fvs = []
    for t, (rows, cols, vidx, bounds) in enumerate(fl):
        if np.any((vidx < 0) | (vidx >= nnz)) or np.any(
                (rows < 0) | (rows >= n)) or np.any((cols < 0) | (cols >= n)):
            rep.add("TRISOLVE_FWD_SET", "executed index out of range", step=t)
            return rep
        _check_rounds(rows, bounds, rep, f"forward level {t}", step=t)
        bad = (indices[vidx] != rows) | (cols_of[vidx] != cols) | (rows <= cols)
        if np.any(bad):
            rep.add("TRISOLVE_FWD_SET",
                    "executed entry disagrees with the L entry it indexes",
                    step=t, n_bad=int(bad.sum()))
        np.minimum.at(rmin, cols, t)
        np.maximum.at(wmax, rows, t)
        fvs.append(vidx)
    got = np.sort(np.concatenate(fvs)) if fvs else np.zeros(0, dtype=np.int64)
    if not np.array_equal(got, np.flatnonzero(lower)):
        rep.add("TRISOLVE_FWD_SET",
                "executed forward entries are not exactly L's",
                got=len(got), want=int(lower.sum()))
    bad = wmax[:n] >= rmin[:n]
    if np.any(bad):
        c = int(np.flatnonzero(bad)[0])
        rep.add("TRISOLVE_FWD_RACE",
                f"x[{c}] written at step {int(wmax[c])} but read at step "
                f"{int(rmin[c])}", col=c, n_bad=int(bad.sum()))

    # backward sweep: step t divides its level columns first, then its
    # updates read x[cols] / write x[rows]
    t_div = np.full(n + 1, -1, dtype=np.int64)
    n_div = np.zeros(n + 1, dtype=np.int64)
    ents = []
    for t, (lcols, ldiag, rows, cols, vidx, bounds) in enumerate(bl):
        if (np.any((lcols < 0) | (lcols >= n))
                or np.any((ldiag < 0) | (ldiag >= nnz))
                or np.any((vidx < 0) | (vidx >= nnz))
                or np.any((rows < 0) | (rows >= n))
                or np.any((cols < 0) | (cols >= n))):
            rep.add("TRISOLVE_BWD_SET", "executed index out of range", step=t)
            return rep
        _check_rounds(rows, bounds, rep, f"backward level {t}", step=t)
        if np.any(ldiag != diag_idx[lcols]):
            rep.add("TRISOLVE_BWD_SET",
                    "division diagonal is not the column's diag_idx", step=t)
        t_div[lcols] = t
        n_div[lcols] += 1
        bad = (indices[vidx] != rows) | (cols_of[vidx] != cols) | (rows >= cols)
        if np.any(bad):
            rep.add("TRISOLVE_BWD_SET",
                    "executed entry disagrees with the U entry it indexes",
                    step=t, n_bad=int(bad.sum()))
        ents.append((rows, cols, vidx, np.full(len(vidx), t, dtype=np.int64)))
    if np.any(n_div[:n] != bmask[:n]):
        rep.add("TRISOLVE_BWD_SET",
                "some column is divided more or less than once",
                n_bad=int((n_div[:n] != bmask[:n]).sum()))
    if ents:
        r, c, v, ts = (np.concatenate([e[i] for e in ents]) for i in range(4))
    else:
        r = c = v = ts = np.zeros(0, dtype=np.int64)
    if not np.array_equal(np.sort(v), np.flatnonzero(upper)):
        rep.add("TRISOLVE_BWD_SET",
                "executed backward entries are not exactly strict U's",
                got=len(v), want=int(upper.sum()))
    bad = (t_div[c] > ts) | (t_div[c] < 0) | (ts >= t_div[r])
    if np.any(bad):
        i = int(np.flatnonzero(bad)[0])
        rep.add("TRISOLVE_BWD_RACE",
                f"update ({int(r[i])}, {int(c[i])}) at step {int(ts[i])} "
                f"races divisions at steps {int(t_div[r[i]])} (row) / "
                f"{int(t_div[c[i]])} (col)",
                n_bad=int(bad.sum()))
    return rep
