"""Process-wide cache of built schedules, and the CUDA-graph capture of one.

The reference's single-dispatch executors compile one XLA program per
schedule and cache it process-wide, keyed by (executor kind, plan digest,
entry, group kinds, dtype, robust, layout, ...), so that a second ``GLU``
on the same plan compiles nothing.  Here a schedule's expensive, shareable
part is its device index tensors: the flat levels' triples in round order,
the ``LevelRun`` layouts of the K1 runs, the dense tail's position lists
and the triangular sweeps' levels.  :class:`ExecutableCache` keeps those
built schedules, keyed like the reference's runners, so a second executor
on the same plan builds no layout and copies no index array to the card.

What the reference's one dispatch becomes on the card is
:class:`CapturedSchedule`: the schedule's launches recorded once into a
``torch.cuda.CUDAGraph`` over static input and output buffers, then one
replay per call.  A graph is bound to its buffers' addresses, so it is
captured per executor instance and never cached: two ``GLU`` objects on
one plan share the index tensors and keep their own factors.  A batch of
B matrices on the plan runs the same built schedule (nothing cached
depends on B, so the cache key holds no batch size); its graph is per
instance and per B, and a call with another B binds new buffers and
captures again.  On the CPU there is no graph: the cached schedule runs
eagerly.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Hashable

import torch

from .. import tracing
from ..kernels import COUNTED

__all__ = [
    "ExecutableCache",
    "ExecutableCacheStats",
    "CapturedSchedule",
    "default_executable_cache",
    "set_default_executable_cache",
    "resolve_executable_cache",
]


@dataclasses.dataclass
class ExecutableCacheStats:
    hits: int = 0
    misses: int = 0
    builds: int = 0
    evictions: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class ExecutableCache:
    """LRU of built schedules, keyed by hashable tuples."""

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._fns: OrderedDict[Hashable, Callable] = OrderedDict()
        self._lock = threading.Lock()
        self.stats = ExecutableCacheStats()

    def get_or_build(self, key: Hashable, builder: Callable[[], Callable]):
        """The cached object for ``key``, building (and caching) it via
        ``builder()`` on a miss."""
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self._fns.move_to_end(key)
                self.stats.hits += 1
                return fn
            self.stats.misses += 1
        fn = builder()             # build outside the lock (it may be slow)
        with self._lock:
            existing = self._fns.get(key)
            if existing is not None:    # racing builder won; keep its object
                self._fns.move_to_end(key)
                return existing
            self.stats.builds += 1
            self._fns[key] = fn
            while len(self._fns) > self.capacity:
                self._fns.popitem(last=False)
                self.stats.evictions += 1
            return fn

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()

    def keys(self) -> list:
        """Snapshot of the cached keys, most recently used last."""
        with self._lock:
            return list(self._fns)

    def __len__(self) -> int:
        return len(self._fns)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._fns


_default_cache = ExecutableCache()


def default_executable_cache() -> ExecutableCache:
    """The process-wide cache the executors use by default."""
    return _default_cache


def set_default_executable_cache(cache: ExecutableCache) -> ExecutableCache:
    """Swap the process-wide default cache; returns the previous one."""
    global _default_cache
    old = _default_cache
    _default_cache = cache
    return old


def resolve_executable_cache(cache):
    """``"default"`` -> the process-wide cache; ``None`` -> no caching
    (a private throwaway cache); an :class:`ExecutableCache` passes
    through."""
    if cache == "default":
        return _default_cache
    if cache is None:
        return ExecutableCache()
    if isinstance(cache, ExecutableCache):
        return cache
    raise TypeError(
        f"executable_cache must be an ExecutableCache, 'default' or None, "
        f"got {cache!r}")


class CapturedSchedule:
    """``fn()`` as one CUDA-graph replay per call.

    ``fn`` takes no arguments: it reads and writes tensors that outlive the
    graph (the caller's static buffers), so each call is "copy new inputs
    into the buffers, replay".  The first call runs ``fn`` eagerly on a
    side stream (the warm-up: it builds the kernel library, fills the
    allocator, and its results are that call's results), then captures
    ``fn`` into the graph without running it; every later call replays.
    Intermediates of the captured work live in the graph's private memory
    pool.  A capture that fails raises: there is no fallback to the eager
    steps.  The warm-up and the capture run on a side stream of
    ``device``, so each card of a sharded sweep captures its own work
    whatever card is current.

    Launch counts: the kernel wrappers count a launch only where one
    happens, so an eager call counts its launches, the capture counts none
    and notes how many of each kernel the graph holds, and each replay adds
    those to the wrappers' counts.

    ``eager_steps`` is the number of host-issued steps of ``fn`` run
    eagerly; a call returns the number of dispatches it issued
    (``eager_steps`` for the warm-up call, 1 for a replay).
    """

    def __init__(self, fn: Callable[[], object], device, eager_steps: int):
        self.fn = fn
        self.device = torch.device(device)
        self.eager_steps = int(eager_steps)
        self.graph = None
        self.launches: dict = {}    # kernel wrapper -> launches per replay

    def __call__(self) -> int:
        if self.graph is not None:
            with tracing.span("exec.replay", self.device, replays=1):
                self.graph.replay()
            for kernel, n in self.launches.items():
                kernel.launches += n
            return 1
        with tracing.span("exec.capture", self.device, captures=1), \
                torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.fn()
            main.wait_stream(side)
            before = [k.captured for k in COUNTED]
            graph = torch.cuda.CUDAGraph()
            # the capture stream must be this device's: torch.cuda.graph's
            # default is one stream made on whichever card came first, and
            # a capture there records nothing of another card's work
            with torch.cuda.graph(graph, stream=side):
                self.fn()
            self.launches = {k: k.captured - b
                             for k, b in zip(COUNTED, before) if k.captured > b}
            self.graph = graph
        return self.eager_steps
