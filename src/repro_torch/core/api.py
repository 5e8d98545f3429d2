"""GLU facade, single matrix: the paper's full flow behind one class.

  A -> MC64 (max-product matching + Dr/Dc scaling) -> fill-reducing
  ordering -> symbolic fill-in -> relaxed dependency detection +
  levelization -> plan -> (re)factorize on the device -> triangular solve
  (+ optional iterative refinement)

Host planning is numpy (:mod:`.planner`, through its content-addressed
plan cache); ``factorize``/``solve`` are the fast repeated path.  The
numeric phase runs on the card by default: SEGMENTED/PANEL levels through
kernel K1, the dense trailing block through kernel K2 (real values) or K3
(complex values, on re/im planes).  ``device="cpu"`` runs the same
schedule with the kernels' plain PyTorch versions.

Permutation algebra: with row_map/col_map (old -> new),
``A_perm[row_map[i], col_map[j]] = A[i, j]``; solving ``A x = b`` becomes
``A_perm x_perm = b_perm`` with ``b_perm = b[inv_row_map]`` and
``x = x_perm[col_map]``.

Scaling algebra: the device factorizes ``B = Dr A Dc``; ``A x = b`` becomes
``B y = Dr b`` with ``x = Dc y``.  The componentwise backward error is
invariant under both scalings, so refinement's stopping test on the scaled
system is the same test on the original one.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..distributed import (batch_blocks, check_mesh, gather_rows,
                           make_scenario_sharding, map_blocks)
from ..sparse.csc import CSC
from .factorize import TorchFactorizer, ported_layout, value_dtype
from .planner import MC64Scaling, SymbolicPlan, compute_scaling, plan_factorization
from .triangular import TorchTriangularSolver

__all__ = ["GLU", "resolve_value_dtype"]


def _span(name: str):
    """Method decorator: each call is a ``name`` span on the GLU's device
    (the root of its call's spans when the caller is outside the GLU)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, *args, **kwargs):
            with tracing.span(name, getattr(self, "device", None)):
                return fn(self, *args, **kwargs)
        return run
    return wrap


def resolve_value_dtype(dtype, device) -> torch.dtype:
    """The value dtype the device will really hold.  A request that would
    come back narrower (a float64 request held as float32) raises instead
    of degrading in silence."""
    requested = value_dtype(dtype)
    effective = torch.empty(0, dtype=requested, device=device).dtype
    if effective != requested:
        raise ValueError(f"requested value dtype {requested} would be held as "
                         f"{effective} on {device}; request {effective} "
                         f"explicitly")
    return requested


class GLU:
    """Refactorize-and-solve on one sparsity pattern.

    ``device``: ``None`` runs on the card (and raises when there is none),
    ``"cpu"`` runs the plain PyTorch versions of the kernels.

    ``dtype``: float64 (default), float32, complex128 or complex64.  Complex
    values (AC analysis, ``A = G + jwC``) take ``layout="auto"`` or
    ``"planar"`` (K1 and K3 run on their re/im planes), or ``"native"``,
    the JAX package's default complex route: every level a flat step in
    PyTorch's complex arithmetic and the dense tail on K3
    (``kernels_disabled_reason`` says so).  Callers see native complex in
    either.  ``"auto"`` is planar here where the JAX package's default
    ``GLU`` resolves it to native (see
    :func:`~.factorize.ported_layout`).  The batched
    methods
    (``factorize_batched``, ``solve_batched``, ``refactorize_solve``)
    factor and solve B matrices on the pattern in lockstep;
    ``solve_multi`` solves K right-hand sides against one factorization.
    Every solve takes ``rhs_pattern``, the indices (original row
    numbering) of the right-hand side's nonzero support, which prunes the
    triangular sweeps to its reach.

    ``jit_schedule`` (default True): on the card each factorization is one
    CUDA-graph replay, and so is each unrefined solve (a refined one: one
    replay for the solve, one per chunk of refinement sweeps, one
    device-to-host read per chunk); ``False`` issues the steps one by one,
    with the same bits.  ``executable_cache`` shares the built schedules
    (device index tensors) between ``GLU`` objects on one plan; the graphs
    and buffers are each object's own.  ``static_pivot``: the relative
    threshold eps of the static pivot guard, ``|diag| < eps * max|A|``
    bumped just before each level divides by it (complex values keep
    their phase: ``tau * d / |d|``).

    ``mode_override`` ("flat", "segmented" or "panel") runs every level in
    that mode, the paper's kernel-mode ablation
    (:class:`~.factorize.TorchFactorizer`; ``disable_modes`` is the
    factorizer's alone, as in the JAX package).  ``verify``: static plan
    verification (:mod:`repro_torch.analysis`).  ``"off"`` (default) runs
    none; ``"plan"`` verifies the symbolic plan against the pattern
    (levelization against the exact dependency set, every index array);
    ``"full"`` also walks the built factorization and solve schedules as
    executed and, on the card, audits their CUDA-graph replays.  A
    violation raises :class:`~repro_torch.analysis.PlanVerificationError`
    at construction; the report's summary lands in
    ``solve_info["verify_report"]``.

    ``mesh`` (a :class:`~repro_torch.distributed.SweepMesh`, see
    ``make_sweep_mesh``) shards the batched calls: the batch (scenario)
    axis splits into contiguous row blocks over the mesh's devices, each
    shard runs the whole schedule on its block (one replay a shard on the
    card), and rows come back with the unsharded batch's bits.  A batch
    the shard count does not divide is padded with copies of its last
    scenario, whose rows are masked out of results and every per-matrix
    diagnostic; B = 1 and the single-matrix calls stay unsharded.  The
    ``GLU`` lives on the mesh's first device (``device`` may name it and
    nothing else) and returns results there.  A mesh that repeats a
    device runs its shards one after another on it (emulation).
    ``solve_info`` reports ``n_devices`` (1 unsharded), ``batch_spec`` and
    ``n_perturbed_global`` (the static-pivot bumps summed over the padded
    batch, None unless a sharded batch ran with the guard on), and
    ``n_dispatches``/``solve_dispatches`` count a shard's dispatches (1 a
    shard for a replay).

    The JAX package's level-fusion options (``fuse_levels``,
    ``fuse_buckets``, ``bucket_waste``) have no counterpart: every level is
    its own step here.  The other options mean what they mean in the JAX
    package's ``GLU``.
    """

    def __init__(
        self,
        A: CSC,
        ordering: str = "auto",
        symbolic: str = "auto",
        dtype=torch.float64,
        mc64="scale",
        jit_schedule: bool = True,
        executable_cache="default",
        panel_threshold: int = 16,
        static_pivot: Optional[float] = None,
        refine: int = 0,
        refine_tol: Optional[float] = None,
        dense_tail: bool = True,
        dense_tail_density: float = 0.25,
        plan_cache="default",
        layout: str = "auto",
        mesh=None,
        verify: str = "off",
        device=None,
        mode_override: Optional[str] = None,
    ):
        _check_slice(dtype, layout, verify, mesh)
        plan, scaling, from_cache = plan_factorization(
            A, ordering=ordering, symbolic=symbolic, mc64=mc64,
            panel_threshold=panel_threshold, cache=plan_cache)
        self._setup(plan, scaling, A, from_cache=from_cache, dtype=dtype,
                    layout=layout, refine=refine,
                    refine_tol=refine_tol, dense_tail=dense_tail,
                    dense_tail_density=dense_tail_density, device=device,
                    static_pivot=static_pivot, jit_schedule=jit_schedule,
                    executable_cache=executable_cache,
                    mode_override=mode_override, verify=verify, mesh=mesh)

    @classmethod
    def from_plan(
        cls,
        plan: SymbolicPlan,
        A: CSC,
        dtype=torch.float64,
        mc64="scale",
        jit_schedule: bool = True,
        executable_cache="default",
        static_pivot: Optional[float] = None,
        refine: int = 0,
        refine_tol: Optional[float] = None,
        dense_tail: bool = True,
        dense_tail_density: float = 0.25,
        layout: str = "auto",
        mesh=None,
        verify: str = "off",
        device=None,
        mode_override: Optional[str] = None,
    ) -> "GLU":
        """Build a GLU around a prebuilt :class:`SymbolicPlan`, skipping all
        symbolic work.  ``A`` must carry the plan's pattern, and the MC64
        matching of its values must reproduce ``plan.row_perm``; raises
        ``ValueError`` otherwise."""
        _check_slice(dtype, layout, verify, mesh)
        if not plan.matches_pattern(A):
            raise ValueError("matrix pattern differs from the plan's pattern")
        scaling = compute_scaling(A, mc64)
        if not np.array_equal(scaling.row_perm, plan.row_perm):
            raise ValueError(
                "MC64 matching of these values differs from the plan's "
                "row permutation; rebuild the plan (e.g. GLU(A, ...))")
        self = cls.__new__(cls)
        self._setup(plan, scaling, A, from_cache=True, dtype=dtype,
                    layout=layout, refine=refine,
                    refine_tol=refine_tol, dense_tail=dense_tail,
                    dense_tail_density=dense_tail_density, device=device,
                    static_pivot=static_pivot, jit_schedule=jit_schedule,
                    executable_cache=executable_cache,
                    mode_override=mode_override, verify=verify, mesh=mesh)
        return self

    @_span("glu.setup")
    def _setup(self, plan: SymbolicPlan, scaling: MC64Scaling, A: CSC,
               from_cache: bool, dtype, layout: str, refine: int,
               refine_tol: Optional[float],
               dense_tail: bool, dense_tail_density: float, device,
               static_pivot: Optional[float], jit_schedule: bool,
               executable_cache, mode_override: Optional[str],
               verify: str, mesh=None) -> None:
        self.mesh = mesh
        self._shard = make_scenario_sharding(mesh)
        self.device = _mesh_device(mesh, device)
        self.dtype = resolve_value_dtype(dtype, self.device)
        self.n = A.n
        self.symbolic_plan = plan
        self.plan_from_cache = bool(from_cache)
        self._A_scipy = A.to_scipy()
        rows0 = np.asarray(A.indices, dtype=np.int64)
        cols0 = np.repeat(np.arange(A.n, dtype=np.int64), np.diff(A.indptr))
        self.Dr, self.Dc = scaling.Dr, scaling.Dc
        # per-original-entry scale factor: entry (i, j) -> Dr[i] * Dc[j]
        self._scale_data = self.Dr[rows0] * self.Dc[cols0]
        self._scale_identity = bool(np.all(self._scale_data == 1.0))
        self.row_map = plan.row_map
        self.col_map = plan.col_map
        self._inv_row = plan.inv_row
        self._data_perm = plan.data_perm
        scaled = np.asarray(A.data) * self._scale_data
        self._A_perm = CSC(A.n, plan.perm_indptr, plan.perm_indices,
                           scaled[self._data_perm])
        dev = self.device
        # scaled-A COO layout (permuted pattern) for refinement's SpMV
        self._spmv_rows = torch.as_tensor(plan.spmv_rows, dtype=torch.int64,
                                          device=dev)
        self._spmv_cols = torch.as_tensor(plan.spmv_cols, dtype=torch.int64,
                                          device=dev)
        self.pattern = plan.pattern
        self.levelization = plan.levelization
        self.plan = plan.fplan
        self.static_pivot = static_pivot
        self.jit_schedule = bool(jit_schedule)
        with tracing.span("glu.setup.factorizer"):
            self._factorizer = TorchFactorizer(
                self.plan, dtype=self.dtype, device=dev, dense_tail=dense_tail,
                dense_tail_density=dense_tail_density, layout=layout,
                static_pivot=static_pivot, jit_schedule=jit_schedule,
                executable_cache=executable_cache, mode_override=mode_override,
                shard=self._shard)
        self.layout = self._factorizer.layout
        with tracing.span("glu.setup.solver"):
            self._solver = TorchTriangularSolver(
                self.plan, device=dev, jit_schedule=jit_schedule,
                executable_cache=executable_cache, layout=self.layout.name)
        self._vals: Optional[torch.Tensor] = None
        self._vals_batch = None       # a tensor, or a sharded batch
        self._batch_size: Optional[int] = None
        self._batch_pad = 0           # pad rows after the batch's B
        # A's values on the device for refinement: the factorizer's static
        # input buffer, and |A|, refreshed on the first refined solve after
        # each factorization; a batched factorization has its own pair
        self._a_abs_single = torch.empty_like(
            self._factorizer.a_values,
            dtype=self._factorizer.a_values.real.dtype)
        self._a_vals, self._a_abs = (self._factorizer.a_values,
                                     self._a_abs_single)
        self._a_abs_stale = True
        self._a_vals_batch = self._a_abs_batch = None
        self._a_abs_batch_stale = True
        self._n_pert = None
        self.refine_default = int(refine)
        # 4 ulp of the value dtype (of its plane dtype for complex values)
        self.refine_tol = (float(refine_tol) if refine_tol is not None
                           else 4.0 * float(torch.finfo(self.dtype).eps))
        self._info: Optional[dict] = None
        self._stats_pending = False
        self.verify = verify
        self.verify_report = None
        if verify != "off":
            # lazy: the analysis package imports core, not the other way
            from ..analysis import verify_glu

            self.verify_report = verify_glu(self, verify)
            self.verify_report.raise_if_violated()

    # -- numeric phase (repeatable) -----------------------------------------
    def _scaled(self, data: np.ndarray) -> np.ndarray:
        """Values in A's original CSC entry order (the last axis), scaled
        and permuted into the plan's entry order."""
        if not self._scale_identity:
            data = data * self._scale_data
        return data[..., self._data_perm]

    @_span("glu.factorize")
    def factorize(self, a_data=None) -> "GLU":
        """(Re)factorize; ``a_data`` are new values in A's original CSC entry
        order (same pattern: the SPICE refactorization contract).  A batched
        factorization held before is dropped."""
        with tracing.span("glu.prepare"):
            if a_data is None:
                data = np.asarray(self._A_perm.data)
            else:
                data = self._scaled(np.asarray(a_data))
        self._factorizer.load(data)
        self._a_vals, self._a_abs = (self._factorizer.a_values,
                                     self._a_abs_single)
        self._a_abs_stale = True
        self._vals = self._factorizer.run()
        self._vals_batch = self._batch_size = None
        self._n_pert = self._factorizer.last_n_perturbed
        self._stats_pending = True
        self._info = self._base_info()
        self._info["n_dispatches"] = self._factorizer.last_n_dispatches
        return self

    def factorized_values(self) -> torch.Tensor:
        """Factored (nnz,) values in the plan's filled pattern, in the
        native value dtype (complex values as a complex tensor): a copy,
        which later factorizations leave as it is."""
        if self._vals is None:
            raise RuntimeError("call factorize() first")
        return self._vals.clone()

    @_span("glu.solve")
    def solve(self, b, refine: Optional[int] = None,
              rhs_pattern=None) -> np.ndarray:
        """Solve A x = b with the current factorization; ``refine`` extra
        iterative-refinement sweeps reuse the device factors (default: the
        constructor's ``refine``).  ``rhs_pattern``: indices (original row
        numbering) of b's nonzero support; it prunes the triangular sweeps
        to the pattern's reach (raises if b is nonzero outside it)."""
        self._require_single()
        k = self.refine_default if refine is None else int(refine)
        with tracing.span("glu.prepare"):
            pat = self._map_rhs_pattern(rhs_pattern, b)
            bp = (np.asarray(b) * self.Dr)[self._inv_row]
        abs_steps = 0
        if k > 0:
            abs_steps = self._refresh_a_abs()
            xp, rinfo = self._solver.solve_refined(
                self._vals, bp, self._spmv_rows, self._spmv_cols,
                self._a_vals, self._a_abs, max_iter=k, tol=self.refine_tol,
                rhs_pattern=pat)
        else:
            xp = self._solver.solve(self._vals, bp, rhs_pattern=pat)
            rinfo = {"refine_iters": 0, "backward_error": None,
                     "converged": None, "host_syncs": 0}
        self._set_solve_info(rinfo, abs_steps)
        x = _to_host(xp)
        with tracing.span("glu.finish"):
            return x[self.col_map] * self.Dc

    @_span("glu.solve_multi")
    def solve_multi(self, b_multi, refine: Optional[int] = None,
                    rhs_pattern=None) -> np.ndarray:
        """Solve A X^T = B^T: many right-hand sides against the current
        single-matrix factorization (the adjoint/sensitivity workload: K
        seed vectors, one Jacobian).  ``b_multi`` is (K, n), returns
        (K, n); each level is one step for all K (one replay on the card),
        and row k equals :meth:`solve` of ``b_multi[k]`` bit for bit.
        ``rhs_pattern`` is the union support of all rows; with ``refine``
        ``solve_info`` holds (K,) arrays."""
        self._require_single()
        b = np.asarray(b_multi)
        if b.ndim != 2 or b.shape[1] != self.n:
            raise ValueError(f"expected (K, {self.n}) rhs, got shape {b.shape}")
        k = self.refine_default if refine is None else int(refine)
        with tracing.span("glu.prepare"):
            pat = self._map_rhs_pattern(rhs_pattern, b)
            bp = (b * self.Dr[None, :])[:, self._inv_row]
        abs_steps = 0
        if k > 0:
            abs_steps = self._refresh_a_abs()
            xp, rinfo = self._solver.solve_refined_multi(
                self._vals, bp, self._spmv_rows, self._spmv_cols,
                self._a_vals, self._a_abs, max_iter=k, tol=self.refine_tol,
                rhs_pattern=pat)
        else:
            xp = self._solver.solve_multi(self._vals, bp, rhs_pattern=pat)
            rinfo = {"refine_iters": np.zeros(b.shape[0], dtype=np.int64),
                     "backward_error": None, "converged": None,
                     "host_syncs": 0}
        self._set_solve_info(rinfo, abs_steps)
        x = _to_host(xp)
        with tracing.span("glu.finish"):
            return x[:, self.col_map] * self.Dc[None, :]

    def _require_single(self) -> None:
        """Factorize A's own values when nothing is factorized yet; raise
        when the active factorization is batched."""
        if self._vals is None:
            if self._vals_batch is not None:
                raise RuntimeError(
                    "the active factorization is batched: use "
                    "solve_batched(), or call factorize() to refactorize "
                    "one matrix first")
            self.factorize()

    def _refresh_a_abs(self) -> int:
        """|A| of the single factorization for refinement, recomputed once
        after each factorization; returns the steps it took (0 or 1)."""
        if not self._a_abs_stale:
            return 0
        torch.abs(self._a_vals, out=self._a_abs)
        self._a_abs_stale = False
        return 1

    def _map_rhs_pattern(self, rhs_pattern, b) -> Optional[np.ndarray]:
        """Translate a right-hand-side pattern from original row indices to
        the solver's permuted positions, checking that ``b`` really is zero
        outside it (a nonzero there would be dropped in silence by the
        pruned solve)."""
        if rhs_pattern is None:
            return None
        pat = np.unique(np.asarray(rhs_pattern, dtype=np.int64).ravel())
        if pat.size and (pat[0] < 0 or pat[-1] >= self.n):
            raise ValueError(f"rhs_pattern indices out of range [0, {self.n})")
        mask = np.zeros(self.n, dtype=bool)
        mask[pat] = True
        bad = np.asarray(b) != 0
        if bad.ndim == 2:
            bad = bad.any(axis=0)
        if np.any(bad & ~mask):
            raise ValueError(
                "rhs has nonzero entries outside rhs_pattern; the pruned "
                "solve would silently drop them")
        return self.row_map[pat]

    def _set_solve_info(self, rinfo: dict, abs_steps: int) -> None:
        if self._info is None:
            self._info = self._base_info()
        self._info.update(rinfo)
        self._info["solve_dispatches"] = (self._solver.last_n_dispatches
                                          + abs_steps)
        tracing.count(host_syncs=rinfo["host_syncs"])

    # -- batched numeric phase (one plan, many matrices) ----------------------
    @_span("glu.factorize_batched")
    def factorize_batched(self, a_data_batch) -> "GLU":
        """Factorize B matrices on this pattern in lockstep.

        ``a_data_batch``: (B, nnz) values, one matrix a row, each in A's
        original CSC entry order (the Monte-Carlo / parameter-sweep
        refactorization contract: one symbolic plan, many value vectors).
        On the card it is one graph replay: one K1 launch per run and one
        batched K2/K3 launch for the B dense tails.  Matrix b's factors are
        those of :meth:`factorize` on its values, bit for bit.  The
        single-matrix factorization held before is dropped."""
        data = np.asarray(a_data_batch)
        if data.ndim != 2 or data.shape[1] != len(self._data_perm):
            raise ValueError(f"expected (B, {len(self._data_perm)}) values, "
                             f"got shape {data.shape}")
        B = data.shape[0]
        self._batch_pad = 0
        with tracing.span("glu.prepare"):
            scaled = self._scaled(data)
            if self._shard is not None and B > 1:
                # pad with copies of the LAST scenario (a factorizable
                # system, so the pad rows never poison diagnostics with
                # inf/NaN); they are masked out of results and diagnostics
                self._batch_pad = self._shard.pad(B) - B
                if self._batch_pad:
                    scaled = np.concatenate(
                        [scaled, np.repeat(scaled[-1:], self._batch_pad, axis=0)])
        a_vals = self._factorizer.load_batched(scaled)
        if self._a_vals_batch is not a_vals:
            self._a_vals_batch = a_vals
            self._a_abs_batch = map_blocks(a_vals, _empty_abs)
        self._a_abs_batch_stale = True
        self._vals_batch = self._factorizer.run_batched()
        self._batch_size = B
        self._vals = None
        self._n_pert = self._factorizer.last_n_perturbed
        self._stats_pending = True
        self._info = self._base_info(batched=True)
        self._info["n_dispatches"] = self._factorizer.last_n_dispatches
        return self

    def factorized_values_batched(self) -> torch.Tensor:
        """Factored (B, nnz) values of the batched factorization, native
        dtype: a copy."""
        if self._vals_batch is None:
            raise RuntimeError("call factorize_batched() first")
        return gather_rows(self._vals_batch, self.device,
                           self._batch_size).clone()

    @_span("glu.solve_batched")
    def solve_batched(self, b_batch, refine: Optional[int] = None,
                      rhs_pattern=None) -> np.ndarray:
        """Solve A_i x_i = b_i for every matrix of the current batched
        factorization; ``b_batch`` is (B, n), returns (B, n).  With
        ``refine`` the corrections are masked onto the matrices still above
        tolerance; ``solve_info`` then holds (B,) arrays.  An unrefined
        solve is one graph replay on the card.  A ``rhs_pattern`` is the
        batch's union support."""
        if self._vals_batch is None:
            raise RuntimeError("call factorize_batched() first")
        b = np.asarray(b_batch)
        if b.ndim != 2 or b.shape[1] != self.n:
            raise ValueError(f"expected (B, {self.n}) rhs, got shape {b.shape}")
        B = b.shape[0]
        if B != self._batch_size:
            raise ValueError(f"rhs batch of {B} does not match the factorized "
                             f"batch of {self._batch_size}")
        k = self.refine_default if refine is None else int(refine)
        with tracing.span("glu.prepare"):
            pat = self._map_rhs_pattern(rhs_pattern, b)
            bp = (b * self.Dr[None, :])[:, self._inv_row]
            if self._batch_pad:
                # zero right-hand sides for the pad rows: their solution is
                # exactly zero and their backward error 0/0 counts as
                # converged, so refinement never iterates for them
                bp = np.concatenate(
                    [bp, np.zeros((self._batch_pad, self.n), dtype=bp.dtype)])
        abs_steps = 0
        if k > 0:
            if self._a_abs_batch_stale:
                for a, out in zip(batch_blocks(self._a_vals_batch),
                                  batch_blocks(self._a_abs_batch)):
                    torch.abs(a, out=out)
                self._a_abs_batch_stale = False
                abs_steps = 1
            xp, rinfo = self._solver.solve_refined_batched(
                self._vals_batch, bp, self._spmv_rows, self._spmv_cols,
                self._a_vals_batch, self._a_abs_batch, max_iter=k,
                tol=self.refine_tol, rhs_pattern=pat)
            if self._batch_pad:
                rinfo = {key: (v[:B] if isinstance(v, np.ndarray) else v)
                         for key, v in rinfo.items()}
        else:
            xp = self._solver.solve_batched(self._vals_batch, bp,
                                            rhs_pattern=pat)
            rinfo = {"refine_iters": np.zeros(B, dtype=np.int64),
                     "backward_error": None, "converged": None,
                     "host_syncs": 0}
        self._set_solve_info(rinfo, abs_steps)
        x = _to_host(xp[:B])
        with tracing.span("glu.finish"):
            return x[:, self.col_map] * self.Dc[None, :]

    @_span("glu.refactorize_solve")
    def refactorize_solve(self, a_data_batch, b_batch,
                          refine: Optional[int] = None,
                          rhs_pattern=None) -> np.ndarray:
        """Batched refactorize + solve in one call (the Newton inner step
        of a parameter sweep).  Accepts (B, nnz) + (B, n) or a single
        (nnz,) + (n,) pair; the factored values stay on the device between
        the two phases and are kept for later ``solve_batched`` calls.  A
        single pair returns (n,) and leaves the single-matrix contract
        behind: ``solve`` works on its factors and ``solve_info`` holds
        scalars with ``batched=False``."""
        data = np.asarray(a_data_batch)
        b = np.asarray(b_batch)
        single = data.ndim == 1
        if single:
            data, b = data[None], b[None]
        self.factorize_batched(data)
        x = self.solve_batched(b, refine=refine, rhs_pattern=rhs_pattern)
        if not single:
            return x
        self._vals = self._vals_batch[0]
        self._a_vals, self._a_abs = self._a_vals_batch[0], self._a_abs_batch[0]
        self._a_abs_stale = self._a_abs_batch_stale
        if self._n_pert is not None:
            self._n_pert = self._n_pert[0]
        self._info["batched"] = False
        for key in ("refine_iters", "backward_error", "converged"):
            v = self._info.get(key)
            if isinstance(v, np.ndarray):
                self._info[key] = v[0].item()
        return x[0]

    @property
    def refine_converged(self):
        """Convergence flag (and nothing else) of the latest refined solve:
        a bool, a (B,) bool array after a batched one, or None when the
        last solve ran unrefined.  Unlike ``solve_info`` it forces none of
        the deferred device reductions, so the Newton loop can poll it
        every iterate."""
        if self._info is None:
            return None
        return self._info.get("converged")

    def _base_info(self, batched: bool = False) -> dict:
        fz = self._factorizer
        shard = fz.last_shard if batched else None
        return {"batched": batched, "pivot_growth": None, "min_diag": None,
                "n_perturbed": None, "refine_iters": None,
                "backward_error": None, "converged": None,
                "n_groups": self._factorizer.n_groups, "n_dispatches": None,
                "solve_dispatches": None, "layout": self.layout.name,
                "kernels_disabled_reason":
                    self._factorizer.kernels_disabled_reason,
                "n_devices": 1 if shard is None else shard.n_shards,
                "batch_spec": None if shard is None else shard.spec,
                "n_perturbed_global": (None if shard is None
                                       else fz.last_n_perturbed_global),
                "verify_report": (None if self.verify_report is None
                                  else self.verify_report.summary())}

    # -- diagnostics ----------------------------------------------------------
    @property
    def solve_info(self) -> Optional[dict]:
        """Robustness report of the latest factorize/solve, with the JAX
        package's keys for this path (``pallas_disabled_reason`` is
        ``kernels_disabled_reason`` here: None when the kernels ran on the
        card).  ``n_dispatches``/``solve_dispatches`` count dispatches: 1
        for a factorization or an unrefined solve replayed as one CUDA
        graph on the card; on the card's first call of each kind (which
        runs the steps eagerly while it warms up the graph), with
        ``jit_schedule=False`` and on the CPU they count host-issued steps:
        for a factorization the entry scatter, one per flat level, one per
        run of consecutive K1 levels (one kernel launch each) and one for
        the dense tail (grid64 9, rajat12_like 6).  ``n_groups`` counts the
        factorization's steps.  ``n_perturbed`` is the static pivot
        guard's bump count (None when the guard is off), read from the
        device here, like the growth and the smallest diagonal.  After a
        batched factorization (``batched`` True) ``pivot_growth``,
        ``min_diag``, ``n_perturbed`` and the refinement fields are (B,)
        arrays, the pad rows of a sharded batch left out.  ``n_devices``,
        ``batch_spec`` and ``n_perturbed_global`` describe a sharded
        batch (see the class docstring)."""
        if self._info is None:
            return None
        if self._stats_pending:
            from ..kernels.ops import factor_stats

            if self._vals is None:
                B = self._batch_size
                vals, a_vals = (gather_rows(self._vals_batch, self.device, B),
                                gather_rows(self._a_vals_batch, self.device, B))
                n_pert = (None if self._n_pert is None
                          else gather_rows(self._n_pert, self.device, B))
            else:
                vals, a_vals, n_pert = self._vals, self._a_vals, self._n_pert
            growth, min_diag = factor_stats(vals, self._factorizer._diag_idx,
                                            a_vals.abs().amax(-1))
            glob = self._info["n_perturbed_global"]
            self._info.update(
                pivot_growth=_host(growth), min_diag=_host(min_diag),
                n_perturbed=None if n_pert is None else _host(n_pert),
                n_perturbed_global=None if glob is None else _host(glob))
            self._stats_pending = False
        return dict(self._info)

    @property
    def n_devices(self) -> int:
        """Shard count batched calls split over (1 = unsharded)."""
        return 1 if self._shard is None else self._shard.n_shards

    @property
    def nnz_filled(self) -> int:
        return self.pattern.nnz

    @property
    def num_levels(self) -> int:
        return self.levelization.num_levels

    def residual(self, b, x) -> float:
        """||Ax - b||_inf / ||b||_inf on the original system."""
        r = self._A_scipy @ np.asarray(x) - np.asarray(b)
        return float(np.abs(r).max() / (np.abs(b).max() + 1e-300))


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A call's result on the host: its device-to-host read, which waits
    for the card's work on it."""
    with tracing.span("glu.download", x.device, d2h_bytes=x):
        return x.cpu().numpy()


def _host(t: torch.Tensor):
    """A device reduction on the host: a Python number for a 0-d tensor, a
    numpy array for a batch's (B,) one."""
    return t.item() if t.dim() == 0 else t.cpu().numpy()


def _empty_abs(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, dtype=t.real.dtype)


def _mesh_device(mesh, device) -> torch.device:
    """The GLU's device: the mesh's first device, which ``device`` may
    name; without a mesh, :func:`resolve_device` of ``device``."""
    if mesh is None:
        return resolve_device(device)
    first = mesh.devices[0]
    if device is not None:
        want = torch.device(device)
        if want.type != first.type or want.index not in (None, first.index):
            raise ValueError(f"device={device!r} is not the mesh's first "
                             f"device {first}")
    return resolve_device(first)


def _check_slice(dtype, layout, verify, mesh):
    """Refuse bad options before any planning work."""
    ported_layout(layout, dtype)
    check_mesh(mesh)
    if verify not in ("off", "plan", "full"):
        raise ValueError(
            f"verify must be 'off', 'plan' or 'full', got {verify!r}")
