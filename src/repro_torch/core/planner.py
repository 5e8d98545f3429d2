"""Planner subsystem: the GLU preprocessing pipeline as a first-class,
cacheable artifact.

GLU3.0's headline result is making *preprocessing* cheap; this module makes
it cheap to *skip*.  The full host-side symbolic pipeline

  MC64 matching -> fill-reducing ordering -> symbolic fill ->
  dependency levelization -> FactorizePlan -> scaling metadata

is split into its value-dependent part (the MC64 matching and Dr/Dc
scalings, recomputed per matrix — see :func:`compute_scaling`) and its
pattern-dependent part (everything else, owned by :class:`SymbolicPlan` and
built by :func:`build_symbolic_plan`).  :func:`plan_factorization` glues the
two together through a content-addressed :class:`PlanCache`:

  key = hash(indptr, indices, row_perm, resolved ordering,
             resolved symbolic, panel_threshold)

so a Newton re-scaling rebuild, a parameter-sweep corner, or a repeated
benchmark construction with a byte-identical pattern (and an unchanged MC64
matching — the usual case for diagonally dominant circuit Jacobians, whose
cheap-pass matching is the identity) reuses the whole symbolic artifact and
performs zero symbolic fill / dependency work.  The cache is an in-memory
LRU.

This is the host-side (numpy) half of the PyTorch port: it builds the same
plan arrays, byte for byte, as the JAX package's planner.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Optional, Union

import numpy as np

from ..sparse.csc import CSC, pattern_digest
from .dependency import Levelization, levelize_relaxed
from .ordering import (
    fill_reducing_ordering,
    max_product_matching,
    resolve_ordering_method,
    zero_free_diagonal,
)
from .plan import FactorizePlan, build_plan
from .symbolic import FilledPattern, resolve_symbolic_method, symbolic_fillin

__all__ = [
    "MC64Scaling",
    "PlanCache",
    "PlanCacheStats",
    "SymbolicPlan",
    "build_symbolic_plan",
    "compute_scaling",
    "default_plan_cache",
    "plan_factorization",
    "plan_key",
    "set_default_plan_cache",
]

# part of every plan key; kept equal to the JAX package's value so both
# packages address one pattern by the same key
PLAN_FORMAT_VERSION = 3


# --------------------------------------------------------------------------
# value-dependent half: MC64 matching + scalings
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MC64Scaling:
    """Value-dependent preprocessing output: the MC64 row permutation (old
    row -> new row) and the Duff-Koster dual scalings."""

    row_perm: np.ndarray
    Dr: np.ndarray
    Dc: np.ndarray

    @property
    def identity_scaling(self) -> bool:
        return bool(np.all(self.Dr == 1.0) and np.all(self.Dc == 1.0))


def compute_scaling(A: CSC, mc64: Union[str, bool, None] = "scale") -> MC64Scaling:
    """``"scale"``/``True`` — full Duff-Koster max-product matching with
    Dr/Dc scalings; ``"structural"`` — zero-free diagonal only;
    ``"none"``/``False``/``None`` — identity."""
    if mc64 in (True, "scale"):
        row_perm, Dr, Dc = max_product_matching(A)
    elif mc64 == "structural":
        row_perm = zero_free_diagonal(A)
        Dr = Dc = np.ones(A.n)
    elif mc64 in (False, None, "none"):
        row_perm = np.arange(A.n, dtype=np.int64)
        Dr = Dc = np.ones(A.n)
    else:
        raise ValueError(f"unknown mc64 mode {mc64!r}")
    return MC64Scaling(np.asarray(row_perm, dtype=np.int64), Dr, Dc)


# --------------------------------------------------------------------------
# pattern-dependent half: the SymbolicPlan artifact
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SymbolicPlan:
    """Everything the numeric phase needs that depends only on the sparsity
    pattern (plus the MC64 row permutation it was built under).

    Immutable by convention: one plan is shared by every ``GLU`` built from
    it, across re-scaling rebuilds, sweep corners and cache hits.
    """

    n: int
    key: str                      # content address (plan_key output)
    ordering: str                 # resolved method names
    symbolic: str
    panel_threshold: int
    # the original pattern the plan was built for (validation + scatter)
    orig_indptr: np.ndarray
    orig_indices: np.ndarray
    row_perm: np.ndarray          # MC64 matching the plan assumes
    row_map: np.ndarray           # old row -> new row (matching + ordering)
    col_map: np.ndarray           # old col -> new col
    inv_row: np.ndarray
    # permuted (pre-fill) pattern and the entry-order map into it
    perm_indptr: np.ndarray
    perm_indices: np.ndarray
    data_perm: np.ndarray         # original entry order -> permuted entry order
    pattern: FilledPattern        # filled pattern of the permuted matrix
    levelization: Levelization
    fplan: FactorizePlan
    spmv_rows: np.ndarray         # permuted-A COO layout for refinement SpMV
    spmv_cols: np.ndarray
    build_seconds: dict           # per-stage wall time of the build

    @property
    def nnz(self) -> int:
        return int(self.orig_indptr[-1])

    @property
    def nnz_filled(self) -> int:
        return self.pattern.nnz

    @property
    def num_levels(self) -> int:
        return self.levelization.num_levels

    def matches_pattern(self, A: CSC) -> bool:
        return (A.n == self.n
                and np.array_equal(np.asarray(A.indptr, dtype=np.int64),
                                   self.orig_indptr)
                and np.array_equal(np.asarray(A.indices, dtype=np.int64),
                                   self.orig_indices))


def plan_key(
    n: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    row_perm: np.ndarray,
    ordering: str = "auto",
    symbolic: str = "auto",
    panel_threshold: int = 16,
) -> str:
    """Content address of a symbolic plan.  ``"auto"`` methods are resolved
    first, so an explicit method and its auto-resolution share one entry."""
    return pattern_digest(
        np.asarray(indptr, dtype=np.int64),
        np.asarray(indices, dtype=np.int64),
        np.asarray(row_perm, dtype=np.int64),
        resolve_ordering_method(n, ordering),
        resolve_symbolic_method(n, symbolic),
        int(panel_threshold),
        PLAN_FORMAT_VERSION,
    )


def build_symbolic_plan(
    n: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    row_perm: np.ndarray,
    ordering: str = "auto",
    symbolic: str = "auto",
    panel_threshold: int = 16,
    key: Optional[str] = None,
) -> SymbolicPlan:
    """Run the pattern-dependent preprocessing pipeline once."""
    t_total = time.perf_counter()
    ordering = resolve_ordering_method(n, ordering)
    symbolic = resolve_symbolic_method(n, symbolic)
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    row_perm = np.asarray(row_perm, dtype=np.int64)
    if key is None:
        key = plan_key(n, indptr, indices, row_perm, ordering, symbolic,
                       panel_threshold)
    rows0 = indices
    cols0 = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    t0 = time.perf_counter()
    # fill-reducing ordering runs on the row-permuted pattern (values are
    # irrelevant to mindeg/rcm, so a pattern-only CSC suffices)
    A_rp = CSC(n, indptr.astype(np.int32), indices.astype(np.int32),
               np.ones(len(rows0))).permute(row_perm,
                                            np.arange(n, dtype=np.int64))
    sym_perm = fill_reducing_ordering(A_rp, ordering)
    row_map = sym_perm[row_perm]
    col_map = sym_perm
    inv_row = np.argsort(row_map)
    t_ordering = time.perf_counter() - t0

    t0 = time.perf_counter()
    # permuted pattern + original-entry-order -> permuted-entry-order map
    data_perm = np.lexsort((row_map[rows0], col_map[cols0]))
    perm_rows = row_map[rows0][data_perm]
    perm_cols = col_map[cols0][data_perm]
    perm_indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(perm_cols, minlength=n))]).astype(np.int32)
    perm_indices = perm_rows.astype(np.int32)
    A_perm = CSC(n, perm_indptr, perm_indices, np.ones(len(perm_rows)))
    t_permute = time.perf_counter() - t0

    t0 = time.perf_counter()
    pattern = symbolic_fillin(A_perm, symbolic)
    t_symbolic = time.perf_counter() - t0

    t0 = time.perf_counter()
    levelization = levelize_relaxed(pattern)
    t_levelize = time.perf_counter() - t0

    t0 = time.perf_counter()
    fplan = build_plan(pattern, levelization, panel_threshold=panel_threshold)
    t_plan = time.perf_counter() - t0

    return SymbolicPlan(
        n=n,
        key=key,
        ordering=ordering,
        symbolic=symbolic,
        panel_threshold=int(panel_threshold),
        orig_indptr=indptr,
        orig_indices=indices,
        row_perm=row_perm,
        row_map=row_map,
        col_map=col_map,
        inv_row=inv_row,
        perm_indptr=perm_indptr,
        perm_indices=perm_indices,
        data_perm=data_perm,
        pattern=pattern,
        levelization=levelization,
        fplan=fplan,
        spmv_rows=perm_rows.astype(np.int32),
        spmv_cols=perm_cols.astype(np.int32),
        build_seconds={
            "ordering": t_ordering,
            "permute": t_permute,
            "symbolic": t_symbolic,
            "levelize": t_levelize,
            "plan": t_plan,
            "total": time.perf_counter() - t_total,
        },
    )


# --------------------------------------------------------------------------
# content-addressed plan cache
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    builds: int = 0       # symbolic builds performed on behalf of this cache

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class PlanCache:
    """Content-addressed in-memory LRU of :class:`SymbolicPlan` artifacts.

    ``capacity`` bounds the entry count (plans for big matrices hold the
    full update-triple arrays, so the default stays small).
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._plans: OrderedDict[str, SymbolicPlan] = OrderedDict()
        self._lock = threading.Lock()
        self.stats = PlanCacheStats()

    def get(self, key: str) -> Optional[SymbolicPlan]:
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.stats.hits += 1
                return plan
            self.stats.misses += 1
            return None

    def put(self, key: str, plan: SymbolicPlan) -> None:
        with self._lock:
            self._plans[key] = plan
            self._plans.move_to_end(key)
            while len(self._plans) > self.capacity:
                self._plans.popitem(last=False)
                self.stats.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: str) -> bool:
        return key in self._plans


_default_cache = PlanCache()


def default_plan_cache() -> PlanCache:
    """The process-wide cache the ``GLU`` facade uses by default."""
    return _default_cache


def set_default_plan_cache(cache: PlanCache) -> PlanCache:
    """Swap the process-wide default cache; returns the previous one."""
    global _default_cache
    old = _default_cache
    _default_cache = cache
    return old


def _resolve_cache(cache) -> Optional[PlanCache]:
    if cache == "default":
        return _default_cache
    if cache is None or isinstance(cache, PlanCache):
        return cache
    raise TypeError(f"plan_cache must be a PlanCache, 'default' or None, "
                    f"got {cache!r}")


def plan_factorization(
    A: CSC,
    ordering: str = "auto",
    symbolic: str = "auto",
    mc64: Union[str, bool, None] = "scale",
    panel_threshold: int = 16,
    cache: Union[PlanCache, str, None] = "default",
):
    """Full preprocessing with plan reuse.

    Runs the value-dependent MC64 stage, then either fetches the matching
    pattern-level :class:`SymbolicPlan` from ``cache`` or builds and stores
    it.  Returns ``(plan, scaling, from_cache)``.
    """
    scaling = compute_scaling(A, mc64)
    key = plan_key(A.n, A.indptr, A.indices, scaling.row_perm,
                   ordering, symbolic, panel_threshold)
    c = _resolve_cache(cache)
    plan = c.get(key) if c is not None else None
    if plan is not None:
        return plan, scaling, True
    plan = build_symbolic_plan(A.n, A.indptr, A.indices, scaling.row_perm,
                               ordering=ordering, symbolic=symbolic,
                               panel_threshold=panel_threshold, key=key)
    if c is not None:
        c.stats.builds += 1
        c.put(key, plan)
    return plan, scaling, False
