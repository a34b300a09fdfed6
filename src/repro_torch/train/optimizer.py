"""Optimizers (AdamW, Adafactor), gradient clipping, LR schedules.

The reference's functions and formulas, written in its operation order so
that fp32 results agree to a few ulp (not ``torch.optim``: its AdamW has
other defaults and applies the decay before the step).  ``init(params) ->
state``; ``update(grads, state, params, lr) -> (params, state)``.  States
are ``NamedTuple``s of trees matching ``params``.

Unlike the reference, ``*_update`` and ``clip_by_global_norm`` work in
place under ``torch.no_grad()``: the parameters, moments and gradients
returned are the tensors passed in, updated, so full-width training never
holds two copies of its state.  Callers that keep the old values clone
them first.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from .tree import tree_leaves, tree_map

__all__ = [
    "AdamWState",
    "AdafactorState",
    "adamw_init",
    "adamw_update",
    "adafactor_init",
    "adafactor_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup_cosine",
]


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # int32 scalar


def _count(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


def adamw_init(params) -> AdamWState:
    return AdamWState(mu=tree_map(torch.zeros_like, params), nu=tree_map(torch.zeros_like, params),
                      count=_count(params))


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, AdamWState]:
    count = state.count + 1
    cf = count.float()
    bc1 = 1.0 - b1 ** cf
    bc2 = 1.0 - b2 ** cf

    def step(p, g, m, v):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = m / bc1
        upd.div_((v / bc2).sqrt_().add_(eps)).add_(weight_decay * p)
        p.sub_(upd.mul_(lr))

    tree_map(step, params, grads, state.mu, state.nu)
    return params, AdamWState(mu=state.mu, nu=state.nu, count=count)


class AdafactorState(NamedTuple):
    row: Any  # row second moment (the full one for tensors under 2-D)
    col: Any
    count: torch.Tensor


def adafactor_init(params) -> AdafactorState:
    def rows(p):
        return p.new_zeros(p.shape[:-1]) if p.dim() >= 2 else torch.zeros_like(p)

    def cols(p):
        return p.new_zeros(p.shape[:-2] + p.shape[-1:]) if p.dim() >= 2 else p.new_zeros(())

    return AdafactorState(row=tree_map(rows, params), col=tree_map(cols, params),
                          count=_count(params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, lr, decay: float = 0.8,
                     eps: float = 1e-30) -> Tuple[Any, AdafactorState]:
    """Factored second moment (Shazeer & Stern 2018): O(n + m) state per
    (n, m) matrix instead of O(nm)."""
    count = state.count + 1
    beta = 1.0 - count.float() ** -decay

    def upd(p, g, r, c):
        if p.dim() >= 2:
            r.copy_(beta * r + (1 - beta) * (g * g).mean(-1))
            c.copy_(beta * c + (1 - beta) * (g * g).mean(-2))
            denom = torch.sqrt(r[..., :, None] * c[..., None, :]
                               / torch.clamp_min(r.mean(-1)[..., None, None], eps) + eps)
            p.sub_(lr * g / denom)
        else:
            r.copy_(beta * r + (1 - beta) * g * g)
            p.sub_(lr * g / (torch.sqrt(r) + 1e-8))

    tree_map(upd, params, grads, state.row, state.col)
    return params, AdafactorState(row=state.row, col=state.col, count=count)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, owned=None, reduce=None):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns ``(grads, norm before clipping)``.

    For gradients held in blocks over several devices (the launch tooling's
    sharded steps): ``owned``, a tree of bools matching ``grads``, keeps a
    leaf out of this device's sum of squares where another device counts
    the same block, and ``reduce`` sums the squares over the devices."""
    leaves = tree_leaves(grads)
    counted = leaves if owned is None else [g for g, o in zip(leaves, tree_leaves(owned)) if o]
    sq = sum((torch.sum(g.float() ** 2) for g in counted),
             torch.zeros((), device=leaves[0].device) if owned is not None else 0)
    gnorm = torch.sqrt(sq if reduce is None else reduce(sq))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, gnorm


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1) -> Callable:
    """``lr(step)``, a float32 scalar tensor, as the reference computes it."""
    def lr(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * frac)))

    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int, min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        step = _f32(step) if not torch.is_tensor(step) else step
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return lr
