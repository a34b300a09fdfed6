"""Threefry-2x32 keys and colorings, as ``jax.random`` draws them.

A frozen copy of the draw that the counting engine is specified to make:
``split(prng_key(s), num)``, ``fold_in(key, i)`` and ``randint(key, (n,), 0,
k)`` under JAX's defaults (``threefry2x32``, partitionable).  The benchmark
makes every key with this module and hands the same keys to the program and
to the reference, and the reference draws each coloring from its key again
here.  Words are int64 tensors masked to 32 bits; a key is a ``(..., 2)``
tensor.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The hash of counters ``(x1, x2)`` under key ``(k1, k2)``; all four
    broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)``: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``(..., 2)`` keys -> ``(..., num, 2)``: key ``i`` hashes ``(0, i)``."""
    counters = torch.arange(int(num), dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(counters), counters)
    return torch.stack((y1, y2), dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``(..., 2)`` keys and integer data (one value per key, or a scalar)
    -> ``(..., 2)`` keys."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _mul32(a, b: int):
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK


def randint(key: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``randint(key, (n,), 0, k)`` for one ``(2,)`` key: ``(n,)`` int64."""
    halves = split(key, 2)  # (2, 2)
    counters = torch.arange(int(n), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(halves[:, 0:1], halves[:, 1:2], torch.zeros_like(counters), counters)
    hi, lo = (b1 ^ b2).unbind(0)
    span = max(int(k), 1)
    multiplier = (((2**16 % span) ** 2) & MASK) % span
    return ((_mul32(hi % span, multiplier) + lo % span) & MASK) % span
