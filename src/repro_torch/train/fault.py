"""Fault tolerance: preemption handling and a step watchdog (the JAX
package's ``train/fault.py``).

* ``PreemptionGuard`` installs SIGTERM/SIGINT handlers; the training loop
  polls ``should_stop`` and flushes a checkpoint before it exits.  Over
  the ranks of a process group it polls :meth:`PreemptionGuard.agreed`,
  a max over the ranks: a rank that stopped alone would leave the others
  waiting in the step's next collective, so all stop, and all take part
  in the flush, when one is signalled.
* ``StepWatchdog`` fires a callback when a step outlasts its wall-clock
  budget (checkpoint and abort, or re-dispatch).
* Restarts resume from the newest checkpoint (``checkpoint.py``), which
  stores whole tensors: ``restore_checkpoint(..., device=)`` places them
  on the device the new run trains on.  The data pipeline skips ahead
  deterministically and has no barrier across hosts.
"""
from __future__ import annotations

import signal
import threading

__all__ = ["PreemptionGuard", "StepWatchdog"]


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # non-main thread
        return self

    def _handler(self, signum, frame):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def agreed(self, device) -> bool:
        """``should_stop`` of any rank of the default process group (one
        all-reduce of a flag on ``device``, the group's device); this
        process's own without a group of several ranks."""
        import torch
        import torch.distributed as dist

        if not (dist.is_initialized() and dist.get_world_size() > 1):
            return self.should_stop
        flag = torch.tensor([int(self.should_stop)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item():
            self._stop.set()
        return bool(flag.item())

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


class StepWatchdog:
    """Detects hung/straggling steps: if a step exceeds ``budget_s`` the
    ``on_timeout`` callback fires (checkpoint + abort, or re-dispatch)."""

    def __init__(self, budget_s: float, on_timeout=None):
        self.budget_s = budget_s
        self.on_timeout = on_timeout
        self._timer = None
        self.timed_out = False

    def _fire(self):
        self.timed_out = True
        if self.on_timeout:
            self.on_timeout()

    def __enter__(self):
        self._timer = threading.Timer(self.budget_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer:
            self._timer.cancel()
        return False
