"""Deterministic synthetic data: the LM token stream.

Every batch is a pure function of ``(seed, step)``, so a restarted job
resumes the exact stream position, as bit-exact checkpoint/restart needs.
The draws are the reference's numpy stream, so both packages see the same
tokens.  The click, graph and Cora generators of the reference's pipeline
come with the GNN and recsys models (ROADMAP queue 1 item 15).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device

__all__ = ["token_batches"]


def token_batches(cfg: LMConfig, batch: int, seq_len: int, seed: int = 0, start_step: int = 0,
                  device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Zipf-ish synthetic token stream: ``(tokens, labels)`` per step, int64
    tensors of ``(batch, seq_len)`` on ``device`` (``None``: the card; raises
    here, not at the first batch, without one), labels the tokens shifted
    by one."""
    device = resolve_device(device)

    def stream():
        step = start_step
        while True:
            rng = np.random.default_rng((seed, step))
            # skewed unigram distribution ~ real text token frequencies
            u = rng.random((batch, seq_len + 1))
            toks = torch.as_tensor(np.minimum((u ** -0.7 - 1.0) * 20, cfg.vocab_size - 1)
                                   .astype(np.int64))
            yield toks[:, :-1].to(device), toks[:, 1:].to(device)
            step += 1

    return stream()
