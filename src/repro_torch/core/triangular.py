"""Level-scheduled sparse triangular solves (L y = b, U x = y) in PyTorch,
plus iterative refinement on the device factors.

The forward sweep reuses the factorization levels; the backward sweep uses
the U-row levels computed at plan time.  Each level is one step with its
real entries only (the JAX package pads levels to shared shapes for
``lax.scan``; eager PyTorch needs no such groups), stored in fixed-order
rounds of distinct target rows (``kernels.ops.round_order``): the
scatter-adds are exact and give the same bits on every run.

Refinement runs on whatever system the factors describe (for the GLU
facade, the scaled and permuted one): each sweep computes ``r = b - A x``
with a COO SpMV of A's values, the componentwise backward error
``max_i |r_i| / (|A||x| + |b|)_i`` as the stopping test, and, while above
tolerance, one more triangular solve.

Complex factors and right-hand sides run the same steps in PyTorch's
complex arithmetic (the scatter-adds on re/im plane views, see
``kernels.ops.add_in_rounds_``); the backward error then takes complex
magnitudes, ``|r| / (|A||x| + |b|)``, as the JAX package's planar path
does.  Sweeps run in chunks of
``sync_every`` with the convergence mask applied on the device, so the
common ``refine <= 2`` case costs one device-to-host read.

A batch of B matrices on the plan (the JAX package's ``solve_batched`` and
``solve_refined_batched``) runs the same steps on (B, nnz) factors and
(B, n) vectors: one step a level for the whole batch, each matrix's sums
as alone, the stopping test and its mask per matrix.  Many right-hand
sides against one factorization (``solve_multi``, ``solve_refined_multi``)
run them on (nnz,) factors and (K, n) vectors: each level's gathers of the
factors broadcast over the K rows, so each row gets one solve's bits.

Sparse right-hand sides: circuit RHS vectors are mostly zeros (an AC
excitation is often 1-2 entries), and the solution of ``L y = b`` is
supported exactly on the reach of ``nonzeros(b)`` in L's DAG
(Gilbert-Peierls; cf. Ruipeng Li, arXiv 1710.04985).  ``rhs_pattern``
prunes the sweeps to that reach: only levels that hold a reach column are
kept, and within a level only the entries whose source column is in the
reach, filtered from the full level's round order, so every kept entry is
added in the same round and order as in the full solve and every dropped
one would have added an exact zero.  The pruned solve is the full solve's
bits on the reach, exact zeros off it.  Pruned sweeps are cached per
pattern (an LRU of ``SPARSE_SCHEDULE_CAP``, with their graphs and
buffers) and shared between solvers through the executable cache.

Scenario sharding: a batched solve on factors held as a
:class:`~repro_torch.distributed.ShardedBatch` splits its
right-hand sides into the same row blocks and runs each block on its
shard's solver (its sweeps, pruned ones too, buffers and graphs on its
device).  Every shard's replay is launched before any host read, and a
refined solve steps its chunks in lockstep over the shards with one global
stopping test, as the JAX package's sharded loop does; rows never
interact, so every row has the unsharded batch's bits.  Single and
many-RHS solves stay unsharded.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..distributed import ShardedBatch
from ..kernels.ops import add_in_rounds_, masked_correction, round_order, spmv
from .executor import CapturedSchedule, resolve_executable_cache
from .plan import FactorizePlan

__all__ = ["TorchTriangularSolver", "trisolve_numpy"]


def trisolve_numpy(plan: FactorizePlan, vals: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sequential oracle: unit-lower forward then upper backward solve."""
    n, indptr, indices = plan.n, plan.indptr, plan.indices
    vals = np.asarray(vals)
    dtype = np.result_type(vals.dtype, np.asarray(b).dtype, np.float64)
    vals = vals.astype(dtype, copy=False)
    x = np.array(b, dtype=dtype, copy=True)
    for j in range(n):
        e = int(indptr[j + 1])
        dp = int(plan.diag_idx[j])
        rows = indices[dp + 1 : e]
        x[rows] -= vals[dp + 1 : e] * x[j]
    for j in range(n - 1, -1, -1):
        s = int(indptr[j])
        dp = int(plan.diag_idx[j])
        x[j] /= vals[dp]
        rows = indices[s:dp]
        x[rows] -= vals[s:dp] * x[j]
    return x



def _fwd_level(vals, x, rows, cols, vidx, bounds):
    add_in_rounds_(x, rows, vals[..., vidx] * x[..., cols], bounds, alpha=-1.0)


def _bwd_level(vals, x, lcols, ldiag, rows, cols, vidx, bounds):
    x[..., lcols] = x[..., lcols] / vals[..., ldiag]
    add_in_rounds_(x, rows, vals[..., vidx] * x[..., cols], bounds, alpha=-1.0)


def _residual_berr(rows, cols, a_vals, a_abs, x, b, n: int):
    """r = b - A x and the componentwise backward error (a 0-d tensor; (B,)
    for a batch of (B, n) vectors and (B, nnz_A) values).  Zero
    denominators (a row with |A||x| + |b| == 0) count as converged when
    the residual there is zero and as inf otherwise."""
    r = b - spmv(rows, cols, a_vals, x, n)
    denom = spmv(rows, cols, a_abs, x.abs(), n) + b.abs()
    ra = r.abs()
    pos = denom > 0
    ratio = torch.where(pos, ra / torch.where(pos, denom, torch.ones_like(denom)),
                        torch.where(ra > 0, torch.full_like(ra, torch.inf),
                                    torch.zeros_like(ra)))
    return r, ratio.amax(-1)


def _read_back(stat):
    """Both refinement counters, ``stat = [berr, iters]`` (each 0-d, or
    (B,) for a batch), in one device-to-host read, as numpy arrays."""
    with tracing.span("glu.download", stat.device, d2h_bytes=stat):
        b, i = stat.cpu().numpy()
    return b, i.astype(np.int64)


class _Sweeps:
    """The built forward and backward sweeps of one plan on one device:
    per level its index tensors (device int64, entries in
    :func:`round_order` of their target rows) and round bounds.  Shared
    through the process-wide :class:`~.executor.ExecutableCache`.

    ``fwd_mask`` / ``bwd_mask`` (boolean (n,) column masks, the reaches of
    a right-hand-side pattern) prune the sweeps: a level is kept when it
    holds a masked column, and of it only the masked columns and the
    entries whose source column is masked, taken from the full level's
    round order (emptied rounds dropped), so each kept entry is added in
    the same round and order as in the full sweep."""

    def __init__(self, plan: FactorizePlan, device, fwd_mask=None,
                 bwd_mask=None):
        def level(*head, rows, cols, vidx, keep=None):
            perm, bounds = round_order(rows)
            arrs = (rows[perm], cols[perm], vidx[perm])
            if keep is not None:
                kept = keep[perm]
                sizes = [int(kept[s:e].sum())
                         for s, e in zip(bounds[:-1], bounds[1:])]
                bounds = [0] + np.cumsum([k for k in sizes if k]).tolist()
                arrs = tuple(a[kept] for a in arrs)
            return tuple(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                         device=device)
                         for a in (*head, *arrs)) + (bounds,)

        fwd = []
        for l in range(len(plan.fwd_ptr) - 1):
            s, e = int(plan.fwd_ptr[l]), int(plan.fwd_ptr[l + 1])
            cols = plan.fwd_cols[s:e]
            keep = None
            if fwd_mask is not None:
                keep = fwd_mask[cols]
                if not keep.any():
                    continue
            fwd.append(level(rows=plan.fwd_rows[s:e], cols=cols,
                             vidx=plan.fwd_vidx[s:e], keep=keep))
        bwd = []
        for l in range(len(plan.bwd_ptr) - 1):
            s, e = int(plan.bwd_ptr[l]), int(plan.bwd_ptr[l + 1])
            cs, ce = int(plan.bwd_col_ptr[l]), int(plan.bwd_col_ptr[l + 1])
            lcols = plan.bwd_level_cols[cs:ce]
            cols = plan.bwd_cols[s:e]
            keep = None
            if bwd_mask is not None:
                keep = bwd_mask[cols]
                lcols = lcols[bwd_mask[lcols]]
                if not len(lcols) and not keep.any():
                    continue
            bwd.append(level(lcols, plan.diag_idx[lcols],
                             rows=plan.bwd_rows[s:e], cols=cols,
                             vidx=plan.bwd_vidx[s:e], keep=keep))
        self.fwd, self.bwd = fwd, bwd
        self.n_steps = len(fwd) + len(bwd)

    def run(self, vals, x) -> None:
        """Forward then backward substitution, in place on ``x``: (n,)
        with (nnz,) factors, a batch (B, n) with (B, nnz) factors, or K
        right-hand sides (K, n) with (nnz,) factors, one step a level for
        all rows."""
        for lev in self.fwd:
            _fwd_level(vals, x, *lev)
        for lev in self.bwd:
            _bwd_level(vals, x, *lev)


class _Bound:
    """Static buffers and captured schedules bound to one set of input
    tensors (their addresses, dtypes and shapes) and one right-hand-side
    shape: a graph reads its inputs where they lay at capture."""

    def __init__(self, key, tensors):
        self.key = key
        self.inputs = tensors          # keeps the bound memory alive
        self.bufs: dict = {}
        self.graphs: dict = {}

    def buf(self, name, make):
        b = self.bufs.get(name)
        if b is None:
            b = self.bufs[name] = make()
        return b


def _bind_key(tensors, shape):
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.device)
                 for t in tensors) + (tuple(shape),)


class TorchTriangularSolver:
    """solve(vals, b): forward + backward substitution on factored values,
    one step per level (eager PyTorch needs none of the JAX package's
    padded level groups); ``solve_batched`` and ``solve_refined_batched``
    do the same for a batch of factors in lockstep, ``solve_multi`` and
    ``solve_refined_multi`` for K right-hand sides against one set of
    factors.  Every solve takes ``rhs_pattern``: the indices
    of the right-hand side's nonzero support (for a batch or K rows, their
    union), which prunes the sweeps to its reach (:meth:`schedule_for_pattern`;
    ``b`` must be zero outside it).  A refined solve prunes its first solve
    only: the corrections solve a dense residual on the full sweeps.

    ``jit_schedule``: on the card an unrefined solve is one CUDA-graph
    replay (:class:`~.executor.CapturedSchedule`), and a refined solve one
    replay for the solve and its residual, then one replay per chunk of
    ``sync_every`` refinement sweeps, each followed by one device-to-host
    read of the stopping test; ``False`` issues the steps one by one.  The
    two give the same bits.  A graph is bound to the tensors it was
    captured on (the factors, and for refinement A's COO arrays) and to the
    right-hand side's shape, so a call with other tensors or another K
    captures anew; each pattern has graphs of its own, released with its
    schedule when the LRU evicts it.  The solver owns the right-hand side,
    solution and residual buffers.  On the CPU the steps always run one by
    one.  ``executable_cache`` shares the built sweeps, full and pruned,
    between solvers on one plan, as in :class:`~.factorize.TorchFactorizer`.

    ``layout``: the factors' value layout, ``"native"`` or ``"planar"``
    (the JAX package's argument).  Both hold complex factors as one complex
    tensor here (the planar route's re/im planes are its interleaved
    view), so the sweeps are the same steps in PyTorch's complex
    arithmetic in either, and the layout shares the built sweeps.

    ``last_n_dispatches`` counts the latest call's dispatches: replays plus
    reads on the graph path, host-issued steps plus reads otherwise (and
    for the card's first call of each kind, which runs the steps eagerly
    while it warms up the graph); a sharded batch counts a shard's.

    Batched solves on a :class:`~repro_torch.distributed.ShardedBatch` of
    factors run on one solver a shard (its ``shard_slot`` keys its cached
    sweeps), see the module docstring; their solution comes back on this
    solver's device.
    """

    # pruned schedules kept per rhs pattern (with their graphs and buffers):
    # a handful of excitation patterns without unbounded growth
    SPARSE_SCHEDULE_CAP = 32

    def __init__(self, plan: FactorizePlan, device=None,
                 jit_schedule: bool = True, executable_cache="default",
                 shard_slot=None, layout: str = "native"):
        if layout not in ("native", "planar"):
            raise ValueError(
                f"layout must be 'native' or 'planar', got {layout!r} "
                "(the solver has no dtype to resolve 'auto' against)")
        self.layout = layout
        self.plan = plan
        self.device = resolve_device(device)
        self.jit_schedule = bool(jit_schedule)
        self._shards = None          # each shard's solver, when first used
        self._copies: dict = {}      # tensors of another device, copied here
        self._cache = resolve_executable_cache(executable_cache)
        self._key = ("trisolve", plan.digest, plan.n, len(plan.fwd_ptr),
                     len(plan.bwd_ptr), str(self.device), shard_slot)
        self._sweeps = self._cache.get_or_build(
            self._key, lambda: _Sweeps(plan, self.device))
        # pattern key -> (schedule_for_pattern's entry, its _Sweeps)
        self._sparse_schedules: OrderedDict = OrderedDict()
        self._bound: dict = {}
        self.last_n_dispatches = 0

    @property
    def fwd_levels(self):
        return self._sweeps.fwd

    @property
    def bwd_levels(self):
        return self._sweeps.bwd

    # -- sparse-RHS schedules ----------------------------------------------
    def schedule_for_pattern(self, rhs_pattern):
        """The pruned ``(fwd_levels, bwd_levels, fwd_reach, bwd_reach)`` for
        a right-hand side supported on ``rhs_pattern`` (positions in the
        solver's numbering), memoized per pattern (LRU).  When the reaches
        are every column the full sweeps themselves are returned."""
        return self._schedule(rhs_pattern)[1][0]

    def _schedule(self, rhs_pattern):
        """``(key, (entry, sweeps))`` of the pattern: its normalized bytes,
        the :meth:`schedule_for_pattern` entry and its :class:`_Sweeps`.
        An evicted pattern takes its graphs and buffers with it."""
        pat = np.unique(np.asarray(rhs_pattern, dtype=np.int64).ravel())
        key = pat.tobytes()
        hit = self._sparse_schedules.get(key)
        if hit is not None:
            self._sparse_schedules.move_to_end(key)
            return key, hit
        n = self.plan.n
        freach = self.plan.fwd_reach(pat)
        breach = self.plan.bwd_reach(freach)
        if len(freach) == n and len(breach) == n:
            sweeps = self._sweeps
        else:
            fmask = np.zeros(n, dtype=bool)
            fmask[freach] = True
            bmask = np.zeros(n, dtype=bool)
            bmask[breach] = True
            sweeps = self._cache.get_or_build(
                self._key + (key,),
                lambda: _Sweeps(self.plan, self.device, fmask, bmask))
        hit = self._sparse_schedules[key] = (
            (sweeps.fwd, sweeps.bwd, freach, breach), sweeps)
        while len(self._sparse_schedules) > self.SPARSE_SCHEDULE_CAP:
            old, _ = self._sparse_schedules.popitem(last=False)
            for slot in [s for s in self._bound if s[1] == old]:
                del self._bound[slot]
        return key, hit

    def _sweeps_for(self, rhs_pattern):
        """The sweeps for the right-hand side's support and the id of its
        graphs and buffers: ``"full"`` for the full sweeps."""
        if rhs_pattern is None:
            return self._sweeps, "full"
        key, (_, sweeps) = self._schedule(rhs_pattern)
        return sweeps, ("full" if sweeps is self._sweeps else key)

    def _bind(self, slot, tensors, shape) -> _Bound:
        """The buffers and graphs of ``slot`` (the call kind and the
        pattern's id) for these input tensors and right-hand-side shape,
        new ones if they changed (a new batch size or K too)."""
        key = _bind_key(tensors, shape)
        bound = self._bound.get(slot)
        if bound is None or bound.key != key:
            bound = self._bound[slot] = _Bound(key, tensors)
        return bound

    def _dispatch(self, bound: _Bound, name, fn, eager_steps: int) -> int:
        """Run ``fn``: one replay of its graph on the card, the steps one by
        one otherwise; returns the dispatches issued."""
        if self.device.type != "cuda" or not self.jit_schedule:
            with tracing.span("exec.eager", self.device, eager_steps=eager_steps):
                fn()
            return eager_steps
        graph = bound.graphs.get(name)
        if graph is None:
            graph = bound.graphs[name] = CapturedSchedule(fn, self.device,
                                                          eager_steps)
        return graph()

    # -- solves ----------------------------------------------------------------
    def solve(self, vals: torch.Tensor, b, rhs_pattern=None) -> torch.Tensor:
        """Solve with factored (nnz,) values; returns an (n,) tensor in the
        values' dtype on their device: the solver's solution buffer, which
        the next solve with these values overwrites."""
        return self._solve("solve", vals, b, (self.plan.n,), rhs_pattern)

    def solve_batched(self, vals: torch.Tensor, b,
                      rhs_pattern=None) -> torch.Tensor:
        """Row b of the result solves with factors ``vals[b]`` and
        right-hand side ``b[b]``: (B, nnz) factors, (B, n) right-hand
        sides, B solves in lockstep (one step a level for the batch, one
        replay on the card); a buffer as in :meth:`solve`.  A
        ``rhs_pattern`` is the batch's union support."""
        _check_batch(vals, b, self.plan.n)
        if isinstance(vals, ShardedBatch):
            subs = self._shard_solvers(vals)
            outs = [s.solve_batched(v, blk, rhs_pattern) for s, v, blk in
                    zip(subs, vals.parts, vals.sharding.split(b))]
            self.last_n_dispatches = max(s.last_n_dispatches for s in subs)
            return torch.cat([x.to(self.device) for x in outs])
        return self._solve("solve_batched", vals, b, (vals.shape[0], self.plan.n),
                           rhs_pattern)

    def _shard_solvers(self, vals: ShardedBatch) -> list:
        """One solver a shard of ``vals``'s sharding, on its device, its
        sweeps cached under its own slot: built at the first sharded
        solve."""
        sh = vals.sharding
        if self._shards is None or self._shards[0] != sh:
            self._shards = (sh, [
                TorchTriangularSolver(self.plan, device=d,
                                      jit_schedule=self.jit_schedule,
                                      executable_cache=self._cache,
                                      shard_slot=(sh.descriptor, i),
                                      layout=self.layout)
                for i, d in enumerate(sh.devices)])
        return self._shards[1]

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on this solver's device: a copy made once and kept (the
        graphs bind its address) when it lies on another."""
        if t.device == self.device:
            return t
        key = (t.data_ptr(), t.dtype, tuple(t.shape), t.device)
        c = self._copies.get(key)
        if c is None:
            c = self._copies[key] = (t, t.to(self.device))
        return c[1]

    def solve_multi(self, vals: torch.Tensor, b,
                    rhs_pattern=None) -> torch.Tensor:
        """Many right-hand sides against one set of factors: (nnz,) values,
        (K, n) right-hand sides, one step a level for all K (one replay on
        the card); row k equals :meth:`solve` of ``b[k]`` bit for bit.  A
        ``rhs_pattern`` is the rows' union support; a buffer as in
        :meth:`solve`."""
        K = _check_multi(vals, b, self.plan.n)
        return self._solve("solve_multi", vals, b, (K, self.plan.n),
                           rhs_pattern)

    def _solve(self, slot, vals, b, shape, rhs_pattern) -> torch.Tensor:
        sweeps, pid = self._sweeps_for(rhs_pattern)
        bound = self._bind((slot, pid), (vals,), shape)
        x = bound.buf("x", lambda: torch.empty(shape, dtype=vals.dtype,
                                               device=vals.device))
        with tracing.span("glu.upload", x.device, h2d_bytes=x):
            x.copy_(torch.as_tensor(b, dtype=vals.dtype))
        self.last_n_dispatches = self._dispatch(
            bound, "solve", lambda: sweeps.run(vals, x), sweeps.n_steps)
        return x

    def solve_refined(self, vals, b, a_rows, a_cols, a_vals, a_abs,
                      max_iter: int, tol: float, rhs_pattern=None,
                      sync_every: int = 2):
        """Solve then refine: up to ``max_iter`` sweeps of
        ``x += solve(b - A x)`` on the existing factors, stopping when the
        componentwise backward error drops to ``tol``.  ``a_rows``/
        ``a_cols``/``a_vals`` describe A in COO entry order and ``a_abs`` is
        ``|a_vals|``.  Returns ``(x, info)`` with ``refine_iters``,
        ``backward_error``, ``converged`` and ``host_syncs``; ``x`` is the
        solver's buffer, as in :meth:`solve`.  ``rhs_pattern`` prunes the
        first solve; the corrections run the full sweeps."""
        return self._solve_refined("refine", vals, b, (self.plan.n,), a_rows,
                                   a_cols, a_vals, a_abs, max_iter, tol,
                                   rhs_pattern, sync_every)

    def solve_refined_batched(self, vals, b, a_rows, a_cols, a_vals, a_abs,
                              max_iter: int, tol: float, rhs_pattern=None,
                              sync_every: int = 2):
        """Batched twin of :meth:`solve_refined`: (B, nnz) factors, (B, n)
        right-hand sides, (B, nnz_A) ``a_vals`` and ``a_abs``; one
        lockstep sweep a round, corrections masked onto the matrices still
        above ``tol``, until all meet it or ``max_iter`` is reached.
        ``refine_iters``, ``backward_error`` and ``converged`` are (B,)
        arrays."""
        _check_batch(vals, b, self.plan.n)
        if isinstance(vals, ShardedBatch):
            subs = self._shard_solvers(vals)
            refs = [s._refinement("refine_batched", v, blk, (v.shape[0], s.plan.n),
                                  s._local(a_rows), s._local(a_cols), av, aa,
                                  tol, rhs_pattern)
                    for s, v, blk, av, aa in zip(
                        subs, vals.parts, vals.sharding.split(b),
                        a_vals.parts, a_abs.parts)]
            reads, syncs = _refine_lockstep(refs, max_iter, tol, sync_every)
            self.last_n_dispatches = max(r.n_disp for r in refs) + syncs
            berr = np.concatenate([r[0] for r in reads])
            iters = np.concatenate([r[1] for r in reads])
            x = torch.cat([r.x.to(self.device) for r in refs])
            return x, _refine_info(berr, iters, tol, syncs)
        return self._solve_refined("refine_batched", vals, b,
                                   (vals.shape[0], self.plan.n), a_rows,
                                   a_cols, a_vals, a_abs, max_iter, tol,
                                   rhs_pattern, sync_every)

    def solve_refined_multi(self, vals, b, a_rows, a_cols, a_vals, a_abs,
                            max_iter: int, tol: float, rhs_pattern=None,
                            sync_every: int = 2):
        """Many-RHS twin of :meth:`solve_refined`: (nnz,) factors and
        ``a_vals``, (K, n) right-hand sides, corrections masked per row;
        ``refine_iters``, ``backward_error`` and ``converged`` are (K,)
        arrays."""
        K = _check_multi(vals, b, self.plan.n)
        return self._solve_refined("refine_multi", vals, b, (K, self.plan.n),
                                   a_rows, a_cols, a_vals, a_abs, max_iter,
                                   tol, rhs_pattern, sync_every)

    def _solve_refined(self, slot, vals, b, shape, a_rows, a_cols, a_vals,
                       a_abs, max_iter, tol, rhs_pattern, sync_every):
        ref = self._refinement(slot, vals, b, shape, a_rows, a_cols, a_vals,
                               a_abs, tol, rhs_pattern)
        [(berr_h, iters_h)], syncs = _refine_lockstep([ref], max_iter, tol,
                                                      sync_every)
        self.last_n_dispatches = ref.n_disp + syncs
        if not shape[:-1]:
            berr_h, iters_h = float(berr_h), int(iters_h)
        return ref.x, _refine_info(berr_h, iters_h, tol, syncs)

    def _refinement(self, slot, vals, b, shape, a_rows, a_cols, a_vals,
                    a_abs, tol, rhs_pattern) -> "_Refinement":
        """A refined solve's buffers and steps, bound to these tensors."""
        first, pid = self._sweeps_for(rhs_pattern)
        bound = self._bind((slot, pid), (vals, a_rows, a_cols, a_vals, a_abs),
                           shape)
        return _Refinement(self, bound, first, vals, b, shape, a_rows, a_cols,
                           a_vals, a_abs, tol)


class _Refinement:
    """One refined solve on one device: ``head`` dispatches ``x =
    solve(b)`` and its residual, ``chunk(k)`` k refinement sweeps,
    ``read`` the stopping test's counters (one device-to-host read).
    ``n_disp`` counts the dispatches issued."""

    def __init__(self, solver, bound, first, vals, b, shape, a_rows, a_cols,
                 a_vals, a_abs, tol):
        n = solver.plan.n
        dev = vals.device
        full = solver._sweeps
        lead = tuple(shape[:-1])
        real = vals.real.dtype

        def buf(name, shape, dtype):
            return bound.buf(name, lambda: torch.empty(shape, dtype=dtype,
                                                       device=dev))

        b_buf, x, r, d = (buf(k, shape, vals.dtype) for k in ("b", "x", "r", "d"))
        berr = buf("berr", lead, real)
        iters = buf("iters", lead, torch.int64)
        stat = buf("stat", (2,) + lead, real)
        with tracing.span("glu.upload", dev, h2d_bytes=b_buf):
            b_buf.copy_(torch.as_tensor(b, dtype=vals.dtype))

        def residual():
            r_new, berr_new = _residual_berr(a_rows, a_cols, a_vals, a_abs,
                                             x, b_buf, n)
            r.copy_(r_new)
            berr.copy_(berr_new)
            torch.stack([berr, iters.to(real)], out=stat)

        def head():                           # x = solve(b), r = b - A x
            x.copy_(b_buf)
            first.run(vals, x)
            iters.zero_()
            residual()

        def chunk(k):                         # k refinement sweeps
            for _ in range(k):
                d.copy_(r)
                full.run(vals, d)
                x.copy_(masked_correction(x, d, berr, tol))
                iters.add_(berr > tol)
                residual()

        self.x, self.stat = x, stat
        self._solver, self._bound, self._tol = solver, bound, float(tol)
        self._chunk, self._steps = chunk, full.n_steps
        self.n_disp = solver._dispatch(bound, "head", head, first.n_steps + 1)

    def chunk(self, k: int) -> None:
        self.n_disp += self._solver._dispatch(
            self._bound, ("chunk", k, self._tol), lambda: self._chunk(k),
            k * (self._steps + 2))

    def read(self):
        return _read_back(self.stat)


def _refine_lockstep(refs, max_iter: int, tol: float, sync_every: int):
    """Step refined solves together: every one's chunk of ``sync_every``
    sweeps is dispatched before any is read, and all stop when every
    row of every one meets ``tol`` (or after ``max_iter`` sweeps).
    Returns each one's last ``(berr, iters)`` read and the reads a solve
    took."""
    syncs = done = 0
    reads = None
    while done < max_iter:
        k = min(max(1, int(sync_every)), max_iter - done)
        for ref in refs:
            ref.chunk(k)
        done += k
        reads = [ref.read() for ref in refs]
        syncs += 1
        if all(np.all(berr <= tol) for berr, _ in reads):
            break
    if reads is None:                       # max_iter == 0
        reads = [ref.read() for ref in refs]
        syncs += 1
    return reads, syncs


def _refine_info(berr, iters, tol: float, syncs: int) -> dict:
    return {"refine_iters": iters, "backward_error": berr,
            "converged": berr <= tol, "host_syncs": syncs}


def _check_batch(vals, b, n: int) -> None:
    shape = tuple(np.shape(b))
    if vals.dim() != 2 or shape != (vals.shape[0], n):
        raise ValueError(f"expected (B, nnz) factors and (B, {n}) right-hand "
                         f"sides, got {tuple(vals.shape)} and {shape}")


def _check_multi(vals, b, n: int) -> int:
    """K of (nnz,) factors and (K, n) right-hand sides; raises otherwise."""
    shape = tuple(np.shape(b))
    if vals.dim() != 1 or len(shape) != 2 or shape[1] != n:
        raise ValueError(f"expected (nnz,) factors and (K, {n}) right-hand "
                         f"sides, got {tuple(vals.shape)} and {shape}")
    return shape[0]
