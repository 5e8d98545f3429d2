"""Batched serving engine: prefill + greedy decode with KV caches, plus a
request scheduler that reuses the paper's levelizer for dependency-ordered
batching (requests whose prompt extends another request's output must wait
— the same "column depends on column" structure GLU levelizes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..convert import lm_params_from_arrays
from ..core.dependency import levelize
from ..device import resolve_device
from ..models.model import LM, forward_decode, forward_prefill

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray             # (S,) prompt
    max_new: int = 16
    parent: Optional[int] = None   # must complete before this request runs
    output: Optional[np.ndarray] = None


class ServeEngine:
    """Greedy generation on one device.  ``params_or_model`` is an
    :class:`~repro_torch.models.LM` on that device, or a parameter tree in
    the JAX package's layout (see :func:`repro_torch.convert.lm_params_from_arrays`).
    ``device=None`` is the card and raises without one; ``"cpu"`` runs
    here.  ``extras`` (patch embeddings, audio frames) are moved to the
    device once."""

    def __init__(self, cfg, params_or_model, extras=None, device=None):
        dev = resolve_device(device)
        if isinstance(params_or_model, LM):
            model = params_or_model
            if model.cfg != cfg:
                raise ValueError(f"the model was built for {model.cfg.name}, "
                                 f"not for {cfg.name}")
            if model.device != torch.empty(0, device=dev).device:
                raise ValueError(f"the model lies on {model.device}, the "
                                 f"engine on {dev}; build it there")
        else:
            model = lm_params_from_arrays(cfg, params_or_model, device=dev)
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.extras = None if extras is None else {
            k: torch.as_tensor(v, device=self.device) for k, v in extras.items()}

    @torch.inference_mode()
    def prefill(self, tokens, max_len: int):
        """(last-token logits (B, V), cache) for prompts (B, S)."""
        return forward_prefill(self.model, tokens, self.cfg, self.extras,
                               max_len=max_len)

    @torch.inference_mode()
    def decode(self, token, cache):
        """(logits (B, V), cache) for one step of tokens (B, 1)."""
        return forward_decode(self.model, token, cache, self.cfg, self.extras)

    @torch.inference_mode()
    def generate_batch(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """prompts (B, S) -> greedy continuations (B, max_new), int32.  The
        tokens stay on the device until the last step."""
        B, S = prompts.shape
        logits, cache = self.prefill(prompts, S + max_new)
        outs = []
        tok = logits.argmax(-1, keepdim=True)
        for _ in range(max_new):
            outs.append(tok)
            logits, cache = self.decode(tok, cache)
            tok = logits.argmax(-1, keepdim=True)
        return torch.cat(outs, 1).to(torch.int32).cpu().numpy()

    # -- dependency-aware scheduling (levelizer reuse) -----------------------
    def run(self, requests: list[Request], batch_size: int = 8) -> dict[int, np.ndarray]:
        idx = {r.rid: i for i, r in enumerate(requests)}
        src, dst = [], []
        for r in requests:
            if r.parent is not None:
                src.append(idx[r.parent])
                dst.append(idx[r.rid])
        lv = levelize(len(requests),
                      np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64))
        results: dict[int, np.ndarray] = {}
        # effective (spliced) prompt per request, built without mutating the
        # caller's Request.tokens: a grandchild still sees its parent's full
        # context through this dict, and running the scheduler twice on the
        # same request list cannot double-prepend the parent prompt
        eff: dict[int, np.ndarray] = {}
        for level in range(lv.num_levels):
            ready = [requests[i] for i in lv.columns_at(level)]
            # bucket by (prompt length, max_new): one shape a batch
            buckets: dict[tuple, list[Request]] = {}
            for r in ready:
                # child prompts extend the parent's output
                toks = r.tokens
                if r.parent is not None:
                    toks = np.concatenate([eff[r.parent],
                                           results[r.parent], r.tokens])
                eff[r.rid] = toks
                buckets.setdefault((len(toks), r.max_new), []).append(r)
            for (slen, max_new), rs in buckets.items():
                for c in range(0, len(rs), batch_size):
                    group = rs[c : c + batch_size]
                    batch = np.stack([eff[r.rid] for r in group])
                    out = self.generate_batch(batch, max_new)
                    for r, o in zip(group, out):
                        r.output = o
                        results[r.rid] = o
        return results
