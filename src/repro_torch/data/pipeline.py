"""Synthetic token pipeline: deterministic, host-sharded, prefetching (the
JAX package's ``data/pipeline.py``; numpy, batch for batch the same).

Determinism contract: batch for (step, host) is a pure function of
(seed, step, host) — restart/elastic-rescale resumes mid-stream exactly
(``skip_to``), and no host ever blocks on another host's input queue
(straggler mitigation: the input path has no global barrier).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        batch: int,             # per-host batch
        seq_len: int,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
        extras_fn=None,         # optional fn(rng, batch) -> dict of stub inputs
    ):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.step = 0
        self.extras_fn = extras_fn
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        # Markov-ish stream so the loss is learnable (not pure noise)
        base = rng.integers(0, self.vocab_size, size=(self.batch, 1))
        drift = rng.integers(-3, 4, size=(self.batch, self.seq_len))
        toks = (base + np.cumsum(drift, axis=1)) % self.vocab_size
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.extras_fn:
            out.update(self.extras_fn(rng, self.batch))
        return out

    def skip_to(self, step: int) -> None:
        self.step = step

    def _work(self):
        while not self._stop.is_set():
            b = self.batch_at(self.step)
            self.step += 1
            self._q.put(b)

    def start(self) -> "TokenPipeline":
        self._worker = threading.Thread(target=self._work, daemon=True)
        self._worker.start()
        return self

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._worker is None:
            b = self.batch_at(self.step)
            self.step += 1
            return b
        return self._q.get()

    def stop(self):
        self._stop.set()
