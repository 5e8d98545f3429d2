"""Spans and counters inside the port: where a call's host time goes, and
which of it the card spends busy.

Off by default.  While it is off a span site costs one check of a module
flag: no clock is read, no CUDA event is made and no counter moves.
:func:`enable` turns it on, :func:`disable` off, and :func:`drain` hands
over what was recorded and empties the buffer; spans stay in memory until
then.

A span is a named interval of host time (``time.perf_counter_ns``) with
its own id, its parent's id and the id of the outermost span it runs in,
the public call it belongs to (``call``; a root span's own id).  Spans nest
per thread.  A span given a CUDA device also records a CUDA event on that
device's current stream as it opens and as it closes, so the pair times
the device work it enqueued; the events are read by :func:`drain`, after
the calls have synchronized with the card, never by a synchronization of
the call itself.  A span may carry counters (``h2d_bytes=`` ...), amounts
it adds, a tensor counting as its size in bytes.  While a
``torch.profiler`` session is active each span also opens a
``record_function`` range of its name, so the profiler's trace shows it
beside the kernels it launched.

The spans of the port (``core/api.py``, ``core/factorize.py``,
``core/triangular.py``, ``core/executor.py``, ``core/planner.py``,
``kernels/_build.py``):

- ``glu.factorize``, ``glu.factorize_batched``, ``glu.solve``,
  ``glu.solve_batched``, ``glu.solve_multi``, ``glu.refactorize_solve``:
  the public calls (a call made inside another is its child);
- ``glu.prepare``: the numpy on a call's inputs (scaling, permutation,
  the right-hand-side pattern, a shard's pad); ``glu.finish``: the numpy
  on its outputs;
- ``glu.upload`` (``h2d_bytes``): host-to-device copies into the static
  buffers; ``glu.download`` (``d2h_bytes``): device-to-host reads, the
  host's wait for the card included (refinement's stopping test too);
- ``exec.replay`` (``replays``), ``exec.capture`` (``captures``: the
  first call's warm-up and capture), ``exec.eager`` (``eager_steps``: the
  steps issued one by one);
- ``plan.mc64``, ``plan.ordering``, ``plan.permute``, ``plan.symbolic``,
  ``plan.levelize``, ``plan.build``: planning;
- ``glu.setup`` with ``glu.setup.factorizer`` and ``glu.setup.solver``:
  a ``GLU``'s build; ``kernels.load``, ``kernels.build``: the kernel
  library's load and its build.

The solves' roots carry ``host_syncs``, refinement's reads.  The counters
the port keeps anyway (the kernel wrappers' launches, the executable and
plan caches' statistics) are not counted again: :func:`drain` reports how
far they moved.
"""
from __future__ import annotations

import itertools
import threading
import time

import torch

__all__ = ["enable", "disable", "enabled", "drain", "span", "timed", "count"]

_on = False                   # the flag every span site checks
_spans: list = []             # finished spans, until drain()
_ids = itertools.count(1)
_local = threading.local()    # each thread's open spans, innermost last
_base: dict = {}              # the port's own counters at enable() / drain()


def enabled() -> bool:
    return _on


def enable() -> None:
    """Record spans from now on; the port's own counters are read from
    here."""
    global _on
    if not _on:
        _base.update(_port_counters())
        _on = True


def disable() -> None:
    """Record no more spans; what was recorded stays until :func:`drain`."""
    global _on
    _on = False


class _Off:
    """What a span site gets while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, device=None, **counters):
    """A ``with`` block recorded as span ``name``; ``device`` (a CUDA
    device) gives it a CUDA event pair, ``counters`` the amounts it adds."""
    if not _on:
        return _OFF
    return Span(name, device, counters, True)


def timed(name: str) -> "Span":
    """A ``with`` block whose host time is read whether or not the tracer
    is on (its ``seconds`` after the block), recorded as span ``name`` when
    it is on."""
    return Span(name, None, {}, _on)


def count(**counters) -> None:
    """Add ``counters`` to the innermost open span of this thread."""
    if not _on:
        return
    stack = _stack()
    if stack:
        stack[-1].add(counters)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _amount(v) -> int:
    return v.nbytes if isinstance(v, torch.Tensor) else int(v)


class Span:
    """One recorded interval; see the module docstring."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns",
                 "counters", "events", "_device", "_record", "_range")

    def __init__(self, name, device, counters, record: bool):
        self.name = name
        self.counters = {k: _amount(v) for k, v in counters.items()}
        self._device = device
        self._record = record
        self.events = self._range = None
        self.id = self.parent = self.call = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def add(self, counters: dict) -> None:
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0) + _amount(v)

    def _stream(self):
        dev = self._device
        if dev is None:
            return None
        dev = torch.device(dev)
        if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return None
        return torch.cuda.current_stream(dev)

    def __enter__(self):
        if self._record:
            stack = _stack()
            self.id = next(_ids)
            if stack:
                self.parent, self.call = stack[-1].id, stack[-1].call
            else:
                self.call = self.id
            stack.append(self)
            if torch._C._autograd._profiler_enabled():
                self._range = torch.autograd.profiler.record_function(self.name)
                self._range.__enter__()
            stream = self._stream()
            if stream is not None:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), stream)
                self.events[0].record(stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if not self._record:
            return False
        if self.events is not None:
            self.events[1].record(self.events[2])
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _spans.append(self)
        return False


def _port_counters() -> dict:
    """The counters the port keeps anyway, flattened: each kernel
    wrapper's launches and the default executable and plan caches'
    statistics."""
    from .core.executor import default_executable_cache
    from .core.planner import default_plan_cache
    from .kernels import COUNTED

    out = {f"launches.{k.__name__}": k.launches for k in COUNTED}
    for prefix, cache in (("executable_cache", default_executable_cache()),
                          ("plan_cache", default_plan_cache())):
        for k, v in cache.stats.snapshot().items():
            out[f"{prefix}.{k}"] = v
    return out


def _ms(a, b):
    """Device milliseconds from event ``a`` to event ``b``, waiting for
    either one still pending (only when read, after the calls)."""
    for e in (a, b):
        if not e.query():
            e.synchronize()
    return float(a.elapsed_time(b))


def drain() -> dict:
    """Everything recorded since :func:`enable` or the last drain, and the
    buffer emptied.

    ``spans``: one dict a span, in order of start: ``name``, ``id``,
    ``parent``, ``call``, ``start_ns``, ``end_ns``, ``self_ns`` (its time
    less its children's), ``counters``, and for a span with an event pair
    ``device_ms`` (open to close on the card) and ``device_start_ms`` /
    ``device_end_ms``, on one clock a device: milliseconds since the
    first event of the drained spans on that device.  ``counters``: how
    far the port's own counters moved over the same time (the kernel
    wrappers' ``launches.<kernel>``, ``executable_cache.<stat>``,
    ``plan_cache.<stat>`` of the default caches)."""
    global _spans
    spans, _spans = _spans, []
    spans.sort(key=lambda s: s.start_ns)
    child_ns: dict = {}
    for s in spans:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    first: dict = {}                  # device -> its first event
    out = []
    for s in spans:
        rec = {"name": s.name, "id": s.id, "parent": s.parent, "call": s.call,
               "start_ns": s.start_ns, "end_ns": s.end_ns,
               "self_ns": s.end_ns - s.start_ns - child_ns.get(s.id, 0),
               "counters": dict(s.counters)}
        if s.events is not None:
            e0, e1, stream = s.events
            ref = first.setdefault(stream.device, e0)
            rec.update(device_ms=_ms(e0, e1), device_start_ms=_ms(ref, e0),
                       device_end_ms=_ms(ref, e1))
        out.append(rec)
    now = _port_counters()
    moved = {k: v - _base.get(k, 0) for k, v in now.items()}
    _base.update(now)
    return {"spans": out, "counters": moved}
