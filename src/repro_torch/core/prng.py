"""Threefry-2x32 keys and integer draws, bit-equal to ``jax.random``.

The reference draws every coloring with ``jax.random.randint(key, (n,), 0,
k)`` on threefry keys (``PRNGKey``, ``split``, ``fold_in``), under JAX's
defaults ``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True``.  This module computes the same bits
with torch integer ops, so the same seed gives the same colorings, and so
the same estimates, in the port as in the reference, on the CPU and on a
card alike.

Words are held in ``int64`` tensors masked to 32 bits: torch's ``uint32``
lacks the shifts and adds the hash needs.  A key is a ``(..., 2)`` tensor
of two words; every function takes a batch of keys in the leading axes.

What JAX computes, and what is copied here:

* ``PRNGKey(seed)`` is ``(0, seed mod 2**32)`` (32-bit mode);
* the hash ``threefry2x32(k1, k2, x1, x2)``: 20 rounds of add-rotate-xor in
  five groups of four, with a key injection after each group;
* ``split(key, num)[i]`` and ``fold_in(key, i)`` both hash the counter
  ``(0, i)`` under the key (the partitionable split is "fold-like");
* ``random_bits(key, (n,))`` hashes the counters ``(0, j)``, ``j < n``, and
  xors the two output words;
* ``randint(key, shape, lo, hi)`` splits the key in two, draws a high and a
  low word per value, and reduces them by the span ``hi - lo`` as
  ``((hi_bits % span) * mult + lo_bits % span) % span`` in uint32, with
  ``mult = (2**16 % span)**2 mod 2**32 % span``.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["as_keys", "prng_key", "split", "fold_in", "random_bits", "randint", "threefry2x32"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of counters ``(x1, x2)`` under key ``(k1,
    k2)``; all four broadcast against each other (int64 words < 2**32)."""
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


def as_keys(keys, device=None) -> torch.Tensor:
    """``(..., 2)`` keys as an int64 tensor of 32-bit words on ``device``:
    a tensor, or anything numpy reads (``np.asarray(jax_keys)``)."""
    if isinstance(keys, torch.Tensor):
        out = keys.to(device=device if device is not None else keys.device, dtype=torch.int64)
    else:
        words = np.asarray(keys)
        if words.dtype.kind not in "iu":
            raise TypeError(f"keys must be integer words, got {words.dtype}")
        out = torch.as_tensor(words.astype(np.int64), device=device)
    if out.shape[-1:] != (2,):
        raise ValueError(f"keys must have a trailing axis of 2 words, got {tuple(out.shape)}")
    return out & MASK


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the ``(2,)`` key ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def _hash_counters(keys: torch.Tensor, counters: torch.Tensor):
    """Hash counters ``(0, c)`` under every key: ``(..., 2)`` keys and
    ``(m,)`` counters give two ``(..., m)`` words."""
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    return threefry2x32(k1, k2, torch.zeros_like(counters), counters)


def split(keys, num: int) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    keys = as_keys(keys)
    counters = torch.arange(int(num), dtype=torch.int64, device=keys.device)
    return torch.stack(_hash_counters(keys, counters), dim=-1)


def fold_in(keys, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``(..., 2)`` keys and integer data (a scalar,
    or one value per key) -> ``(..., 2)`` keys."""
    keys = as_keys(keys)
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(keys, shape: Union[int, Sequence[int]]) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: ``(..., 2)`` keys -> ``(..., *shape)``
    words."""
    keys = as_keys(keys)
    shape = (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)
    size = int(np.prod(shape, dtype=np.int64))
    if size >= 2**32:
        raise ValueError("more than 2**32 values per key: the counters' high word is not kept")
    counters = torch.arange(size, dtype=torch.int64, device=keys.device)
    b1, b2 = _hash_counters(keys, counters)
    return (b1 ^ b2).reshape(keys.shape[:-1] + shape)


def randint(keys, shape: Union[int, Sequence[int]], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 values, as
    int64): ``(..., 2)`` keys -> ``(..., *shape)`` values in
    ``[minval, maxval)``, or ``minval`` where ``maxval <= minval``."""
    keys = as_keys(keys)
    minval, maxval = int(minval), int(maxval)
    if not -(2**31) <= minval < 2**31 or not -(2**31) <= maxval < 2**31:
        raise ValueError("randint draws int32 values")
    span = 1 if maxval <= minval else maxval - minval
    # both halves of the split key hashed in one pass: (..., 2, *shape)
    bits = random_bits(split(keys, 2), shape)
    hi, lo = bits.unbind(keys.dim() - 1)
    multiplier = (((2**16 % span) ** 2) & MASK) % span
    # uint32 arithmetic, as JAX's: products and sums wrap at 2**32
    offset = (_mul32(hi % span, multiplier) + lo % span) & MASK
    return minval + offset % span


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for words ``a`` and ``b`` without leaving int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK
