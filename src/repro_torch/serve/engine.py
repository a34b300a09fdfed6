"""Batched LM serving engine: continuous-batching-lite on a fixed slot pool.

A ``ServeEngine`` owns a fixed ``(max_batch, max_len)`` KV cache on the
parameters' device.  Requests are admitted into free slots (prefill writes
the prompt into the slot's cache rows from position 0) and all active slots
decode together; finished slots (length budget) are reaped and refilled.

The behaviour is the reference's, step for step, run eagerly in place of
``jax.jit``, with the cache updated in place.  That includes its shared
write index: every decode step writes all slots at the largest active
position, so a slot whose prompt was shorter attends to cache rows its own
prompt never wrote.  Its output then matches offline greedy decoding only
when all prompts have the same length (ROADMAP queue 3).

``stats`` counts prefills and decode steps with their host-clock seconds;
both end in a device-to-host read of the chosen tokens, so the seconds
include the device's work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import transformer as T

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: LMConfig, params, max_batch: int = 8, max_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = params["embed"].device
        self.caches = T.init_kv_cache(cfg, max_batch, max_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, dtype=np.int32)
        self.stats = {"prefills": 0, "prefill_seconds": 0.0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_seconds": 0.0}

    # -- admission -----------------------------------------------------------

    def _prefill_one(self, slot: int, req: Request) -> None:
        """Prefill a single slot: the forward writes into views of the slot's
        cache rows."""
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(req.prompt), device=self.device)[None, :]
        sub_cache = [{k: c[:, slot: slot + 1] for k, c in g.items()} for g in self.caches]
        logits, _ = T.prefill(self.params, self.cfg, prompt, sub_cache)
        self.slot_pos[slot] = len(req.prompt)
        req.generated.append(int(torch.argmax(logits[0, -1])))
        self.stats["prefills"] += 1
        self.stats["prefill_seconds"] += time.perf_counter() - t0

    def admit(self, requests: List[Request]) -> List[Request]:
        """Fill free slots; returns the requests that were admitted."""
        admitted = []
        for req in requests:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free:
                break
            slot = free[0]
            self.slot_req[slot] = req
            self._prefill_one(slot, req)
            admitted.append(req)
        return admitted

    # -- decode loop ---------------------------------------------------------

    def step(self) -> int:
        """One batched decode step over all active slots; returns #active."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        t0 = time.perf_counter()
        tokens = np.zeros((self.max_batch, 1), dtype=np.int32)
        for i in active:
            tokens[i, 0] = self.slot_req[i].generated[-1]
        # all active slots share a write index = max position (aligned pool)
        index = int(self.slot_pos[active].max())
        logits, self.caches = T.decode_step(
            self.params, self.cfg, torch.as_tensor(tokens, device=self.device), self.caches, index
        )
        chosen = torch.argmax(logits, dim=-1).tolist()
        for i in active:
            req = self.slot_req[i]
            req.generated.append(int(chosen[i]))
            self.slot_pos[i] = index + 1
            if len(req.generated) >= req.max_new_tokens or self.slot_pos[i] >= self.max_len - 1:
                req.done = True
                self.slot_req[i] = None
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(active)
        self.stats["decode_seconds"] += time.perf_counter() - t0
        return len(active)

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a request list to completion (admit + decode until drained)."""
        pending = list(requests)
        while pending or any(r is not None for r in self.slot_req):
            admitted = self.admit(pending)
            pending = [r for r in pending if r not in admitted]
            if self.step() == 0 and not pending:
                break
        return requests
