"""Sharded LM steps: one device's share of a cell's step over a mesh.

The reference hands its whole-batch step to ``pjit`` with ``in_shardings``
and lets XLA partition it.  Here every device runs its own share of the
step, written out, and talks to the others through :class:`Comm`:

* parameters live at their cell placement (``cells._fsdp_param_pspecs``):
  every layer's weights are all-gathered just before use and dropped
  after; under ``cfg.remat`` the gather runs again in the backward's
  recompute.  The gather's backward reduce-scatters the gradient back to
  the placement and sums it over the axes the leaf is replicated on, so
  the optimizer updates the shard (:class:`_Gather`).
* activations: each device takes ``batch / n_dp`` sequences of the tokens
  at ``P(dp, None)`` and ``seq / n_model`` positions of them (the
  reference's ``act_spec = P(dp, "model", None)``); attention all-gathers
  keys and values (MLA: the latents) over ``"model"``, with a
  reduce-scatter for backward.
* the loss is each device's mean over its tokens, averaged over the
  devices; the global-norm clip sums squares once per block; AdamW is
  elementwise on the shard, Adafactor sums its factored moments over the
  axes a dimension is split on.
* decode reads a cache sharded along its sequence: each device attends
  over its slice and the partial softmax sums are combined with
  all-reduces (split-K).

MoE layers gather every expert and route this device's tokens alone (no
expert parallelism inside the sharded step).  At one device every
collective is skipped and the step runs the single-device step's
operations in its order, so it is bitwise equal to ``make_lm_job``'s.

:class:`Comm` runs the collectives over ``torch.distributed`` groups of
a realised mesh, or, with no mesh, only makes their outputs' shapes (a
``meta`` trace); either way it logs each as ``(op, bytes, group size)``
in the reference's convention (an all-gather's bytes are its output's, a
reduce-scatter's its input's).  :func:`lm_train_schedule` derives the same
log from the specs alone.
"""

from __future__ import annotations

import itertools
import math
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sharding import (
    P,
    device_coords,
    dim_splits,
    entry_axes,
    shard_shape,
    spec_axes,
    spec_leaves,
    spec_map,
)

__all__ = [
    "Comm",
    "gather_param",
    "make_lm_train_step",
    "make_lm_prefill_step",
    "make_lm_decode_step",
    "lm_train_schedule",
    "schedule_counts",
]


class Comm:
    """This device's collectives over ``mesh`` (an ``AbstractMesh``).

    With ``device_mesh`` (the mesh realised by ``launch.mesh.realize_mesh``
    over the default group), collectives run over ``torch.distributed``
    groups, one per set of axes, made here by every rank in one order.
    Without it they are simulated: outputs get their shapes and no data (a
    ``meta`` trace of device ``rank``).  Every collective over more than one
    device is appended to :attr:`log` as ``(op, bytes, group size, axes)``."""

    def __init__(self, mesh, rank: int = 0, device_mesh=None):
        self.mesh = mesh
        self.rank = int(rank)
        self.coords = device_coords(mesh, self.rank)
        self.world = mesh.size
        self.log: List[Tuple[str, int, int, Tuple[str, ...]]] = []
        self.real = device_mesh is not None
        self._groups: Dict[frozenset, object] = {}
        if self.real:
            self._make_groups(device_mesh)

    def _make_groups(self, device_mesh) -> None:
        import torch.distributed as dist

        names = list(self.mesh.axis_names)
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                if self.size(axes) == 1:
                    continue
                if len(axes) == 1:
                    self._groups[frozenset(axes)] = device_mesh.get_group(axes[0])
                    continue
                if self.size(axes) == dist.get_world_size():
                    self._groups[frozenset(axes)] = dist.group.WORLD
                    continue
                rest = [a for a in names if a not in axes]
                for key in itertools.product(*(range(self.mesh.shape[a]) for a in rest)):
                    members = [d for d in range(self.world)
                               if tuple(device_coords(self.mesh, d)[a] for a in rest) == key]
                    group = dist.new_group(members)  # every rank, every group
                    if self.rank in members:
                        self._groups[frozenset(axes)] = group

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def _order(self, axes: Sequence[str]) -> Optional[torch.Tensor]:
        """Group-rank order (ascending device number) -> position in the
        mixed-radix order of ``axes``; ``None`` where they agree."""
        others = {a: c for a, c in self.coords.items() if a not in axes}
        members = []
        for d in range(self.world):
            c = device_coords(self.mesh, d)
            if all(c[a] == v for a, v in others.items()):
                pos = 0
                for a in axes:
                    pos = pos * self.mesh.shape[a] + c[a]
                members.append(pos)
        if members == sorted(members):
            return None
        return torch.tensor(members)

    # -- primitives ------------------------------------------------------------

    def gather(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """The whole array from this device's block ``x`` at ``spec``: one
        all-gather over every axis the spec names."""
        ndim = x.dim()
        splits = dim_splits(spec, ndim, self.mesh)
        axes = spec_axes(spec)
        g = self.size(axes)
        full = tuple(s * k for s, k in zip(x.shape, splits))
        if g == 1:
            return x
        self.log.append(("all-gather", _nbytes(full, x.dtype), g, axes))
        if not self.real:
            return x.new_empty(full)
        import torch.distributed as dist

        flat = x.new_empty((g * x.numel(),))  # 1-D: gloo takes no stacked output
        dist.all_gather_into_tensor(flat, x.contiguous().view(-1), group=self._groups[frozenset(axes)])
        buf = flat.view((g,) + tuple(x.shape))
        order = self._order(axes)
        if order is not None:  # buf[i] holds block order[i]
            buf = buf[torch.argsort(order).to(buf.device)]
        blocks = buf.view(splits + tuple(x.shape))
        perm = [i for d in range(ndim) for i in (d, ndim + d)]
        return blocks.permute(perm).reshape(full)

    def scatter_sum(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """This device's block of the sum over the spec's axes of every
        device's whole ``x``: one reduce-scatter (:meth:`gather`'s
        transpose)."""
        ndim = x.dim()
        splits = dim_splits(spec, ndim, self.mesh)
        axes = spec_axes(spec)
        g = self.size(axes)
        block = tuple(s // k for s, k in zip(x.shape, splits))
        if g == 1:
            return x
        self.log.append(("reduce-scatter", _nbytes(x.shape, x.dtype), g, axes))
        if not self.real:
            return x.new_empty(block)
        import torch.distributed as dist

        split = x.reshape(tuple(v for k, b in zip(splits, block) for v in (k, b)))
        perm = [2 * d for d in range(ndim)] + [2 * d + 1 for d in range(ndim)]
        buf = split.permute(perm).reshape((g,) + block)
        order = self._order(axes)
        if order is not None:
            buf = buf[order.to(buf.device)]
        out = x.new_empty((math.prod(block),))
        dist.reduce_scatter_tensor(out, buf.contiguous().view(-1), group=self._groups[frozenset(axes)])
        return out.view(block)

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str], op: str = "sum") -> torch.Tensor:
        """``x`` summed (or maxed) over the devices that differ only on
        ``axes``, in place."""
        g = self.size(axes)
        if g == 1:
            return x
        self.log.append(("all-reduce", _nbytes(x.shape, x.dtype), g, tuple(axes)))
        if not self.real:
            return x
        import torch.distributed as dist

        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self._groups[frozenset(axes)])
        return x


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


class _Gather(torch.autograd.Function):
    """All-gather at ``spec`` whose backward reduce-scatters the gradient to
    the block and sums it over ``rest`` (axes the block is replicated on)."""

    @staticmethod
    def forward(ctx, x, comm, spec, rest):
        ctx.comm, ctx.spec, ctx.rest = comm, spec, rest
        out = comm.gather(x, spec)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        g = ctx.comm.scatter_sum(grad.contiguous(), ctx.spec)
        if g is grad:
            g = grad.clone()
        return ctx.comm.all_reduce(g, ctx.rest), None, None, None


def gather_param(comm: Comm, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
    """The whole parameter from its block, differentiable (see
    :class:`_Gather`); ``x`` itself on a one-device mesh."""
    axes = spec_axes(spec)
    rest = tuple(a for a in comm.mesh.axis_names if a not in axes)
    if comm.world == 1:
        return x
    return _Gather.apply(x, comm, spec, rest)


def _seq_gather(comm: Comm, axes: Tuple[str, ...]):
    """``t -> t`` whole along dim 1 (gathered over ``axes``, differentiable,
    no sum over other axes), or ``None`` on one device."""
    if comm.size(axes) == 1:
        return None
    entry = axes[0] if len(axes) == 1 else axes
    return lambda t: _Gather.apply(t, comm, P(None, entry), ())


def _layer_specs(group_specs):
    """A stacked group's specs without the leading layer axis."""
    from repro_torch.models import transformer as T

    return T._map(lambda sp: P(*sp[1:]), group_specs)


def _hidden(comm, cfg, specs, params, tokens, positions, seq_axes=("model",), caches=None):
    """Final-norm hidden states of this device's tokens, the summed MoE aux
    loss, and the gathered embedding: :func:`transformer.forward` with
    every layer's weights gathered at ``specs``, over this device's slice
    of the sequence (``positions``, global)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dtype = getattr(torch, cfg.dtype)
    embed = gather_param(comm, params["embed"], specs["embed"])
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    x = F.embedding(tokens, embed).to(dtype)
    seq = _seq_gather(comm, seq_axes)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()

    aux_total = torch.zeros((), dtype=torch.float32, device=embed.device)
    for g, (n, moe) in enumerate(T.layer_groups(cfg)):
        layers = T._map(lambda p: p.unbind(0), params["groups"][g])
        lspecs = _layer_specs(specs["groups"][g])
        for i in range(n):
            layer = T._map(lambda ps: ps[i], layers)
            cache_l = None if caches is None else {k: c[i] for k, c in caches[g].items()}
            if remat:
                x, aux = checkpoint(_layer, comm, cfg, moe, lspecs, layer, x, positions, seq,
                                    None, use_reentrant=False)
            else:
                x, aux = _layer(comm, cfg, moe, lspecs, layer, x, positions, seq, cache_l)
            aux_total = aux_total + aux
    x = L.rmsnorm(x, gather_param(comm, params["final_norm"], specs["final_norm"]), cfg.norm_eps)
    return x, aux_total, embed


def _layer(comm, cfg, moe, lspecs, layer, x, positions, seq, cache):
    from repro_torch.models import transformer as T

    full = T._zip_map(lambda p, sp: gather_param(comm, p, sp), layer, lspecs)
    x, aux, _ = T._layer_apply(cfg, moe, full, x, positions, cache, None if cache is None else 0,
                               seq_gather=seq)
    return x, aux


def _unembed(comm, params, specs, embed):
    if "unembed" in params:
        return gather_param(comm, params["unembed"], specs["unembed"])
    return embed.T


def _seq_slice(comm, s: int, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """This device's ``[lo, hi)`` of ``s`` positions split over ``axes``."""
    k = comm.size(axes)
    if s % k:
        raise ValueError(f"sequence {s} does not split over {k} devices")
    j = 0
    for a in axes:
        j = j * comm.mesh.shape[a] + comm.coords[a]
    return j * (s // k), (j + 1) * (s // k)


def _owned(comm, specs):
    """Per leaf: does this device count the block in a global sum (its
    coordinate is 0 on every axis the leaf is replicated on)?"""
    def own(spec):
        axes = spec_axes(spec)
        return all(c == 0 for a, c in comm.coords.items() if a not in axes)

    return spec_map(own, specs)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


#: the reference's train cells: learning rate, global-norm clip, the
#: chunked vocabulary loss
LR, MAX_NORM, LOSS_CHUNK = 3e-4, 1.0, 512


def make_lm_train_step(cfg, mesh, specs, *, n_micro: int = 1, adafactor: bool = False):
    """The sharded train step ``fn(comm, params, opt_state, tokens, labels)
    -> (params, opt_state, {"loss", "gnorm"})`` on this device's blocks
    (``params`` at ``specs``, the optimizer state at the cell's optimizer
    specs, tokens and labels ``(batch / n_dp, seq)``), updated in place.
    ``n_micro`` microbatches accumulate their gradients, as the reference's
    scan; the loss by chunks of ``LOSS_CHUNK`` positions, clipping at
    ``MAX_NORM`` and AdamW (Adafactor) at ``LR``."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw_update, clip_by_global_norm
    from repro_torch.train.tree import tree_leaves, tree_map

    every = tuple(mesh.axis_names)

    def step(comm, params, opt_state, tokens, labels):
        world = comm.world
        rows = tokens.shape[0]
        if rows % n_micro:
            raise ValueError(f"{rows} local rows do not split into {n_micro} microbatches")
        mr = rows // n_micro
        lo, hi = _seq_slice(comm, tokens.shape[1], ("model",))
        device = tree_leaves(params)[0].device
        positions = torch.arange(lo, hi, device=device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss_sum = None
        for m in range(n_micro):
            t_m = tokens[m * mr:(m + 1) * mr, lo:hi]
            l_m = torch.as_tensor(labels[m * mr:(m + 1) * mr, lo:hi], device=device).long()
            x, aux, embed = _hidden(comm, cfg, specs, params, t_m, positions)
            loss = T._mean_nll(x, _unembed(comm, params, specs, embed), l_m, LOSS_CHUNK) + aux
            (loss if world == 1 else loss / world).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        grads = tree_map(lambda p: p.grad, params)
        with torch.no_grad():
            if n_micro > 1:
                grads = tree_map(lambda g: g.div_(n_micro), grads)
                loss_sum = loss_sum / n_micro
            if world > 1:
                loss_sum = comm.all_reduce(loss_sum.reshape(1), every)[0] / world
        grads, gnorm = clip_by_global_norm(
            grads, MAX_NORM, owned=_owned(comm, specs) if world > 1 else None,
            reduce=(lambda sq: comm.all_reduce(sq.reshape(1), every)[0]) if world > 1 else None)
        if adafactor:
            params, opt_state = _adafactor_update(comm, grads, opt_state, params, LR, specs)
        else:
            params, opt_state = adamw_update(grads, opt_state, params, LR)
        for p in tree_leaves(params):
            p.requires_grad_(False)
            p.grad = None
        return params, opt_state, {"loss": loss_sum, "gnorm": gnorm}

    return step


@torch.no_grad()
def _adafactor_update(comm, grads, state, params, lr, specs, decay: float = 0.8, eps: float = 1e-30):
    """``optimizer.adafactor_update`` on blocks: the row, column and
    row-mean sums add over the axes their dimension is split on."""
    from repro_torch.train.optimizer import AdafactorState, adafactor_update

    if comm.world == 1:
        return adafactor_update(grads, state, params, lr, decay=decay, eps=eps)
    count = state.count + 1
    beta = 1.0 - count.float() ** -decay

    def upd(spec, p, g, r, c):
        if p.dim() >= 2:
            full = tuple(spec) + (None,) * (p.dim() - len(spec))
            last, row = entry_axes(full[-1]), entry_axes(full[-2])
            n_last, n_row = p.shape[-1] * comm.size(last), p.shape[-2] * comm.size(row)
            gg = g * g
            r.copy_(beta * r + (1 - beta) * (comm.all_reduce(gg.sum(-1), last) / n_last))
            c.copy_(beta * c + (1 - beta) * (comm.all_reduce(gg.sum(-2), row) / n_row))
            r_mean = comm.all_reduce(r.sum(-1), row) / n_row
            denom = torch.sqrt(r[..., :, None] * c[..., None, :]
                               / torch.clamp_min(r_mean[..., None, None], eps) + eps)
            p.sub_(lr * g / denom)
        else:
            r.copy_(beta * r + (1 - beta) * g * g)
            p.sub_(lr * g / (torch.sqrt(r) + 1e-8))

    spec_map(upd, specs, params, grads, state.row, state.col)
    return params, AdafactorState(row=state.row, col=state.col, count=count)


def lm_train_schedule(cfg, mesh, specs, batch: int, seq: int, n_micro: int = 1,
                      adafactor: bool = False) -> List[Tuple[str, int, int]]:
    """The collectives :func:`make_lm_train_step` makes on one device, from
    the specs alone: per microbatch, each gathered block's all-gather (twice
    for a layer's under remat: forward and recompute), each reduce-scatter
    and replica all-reduce of its gradient, and each layer's key/value
    (MLA: latent) all-gather and reduce-scatter over ``"model"``; then the
    loss and the squared norm (and Adafactor's sums)."""
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models import transformer as T
    from repro_torch.train.tree import tree_leaves

    def size(axes):
        return math.prod(mesh.shape[a] for a in axes)

    world, n_model = mesh.size, mesh.shape["model"]
    n_dp = size(dp_axes(mesh))
    rows = batch // n_dp // n_micro
    dtype_bytes = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    shapes = T.param_shapes(cfg)
    log: List[Tuple[str, int, int]] = []

    def leaf(spec, shape, times=1):
        axes = spec_axes(spec)
        rest = [a for a in mesh.axis_names if a not in axes]
        full = math.prod(shape) * 4
        if world == 1:
            return
        if size(axes) > 1:
            log.extend([("all-gather", full, size(axes), axes)] * times)
            log.append(("reduce-scatter", full, size(axes), axes))
        if size(rest) > 1:
            log.append(("all-reduce", math.prod(shard_shape(shape, spec, mesh)) * 4, size(rest),
                        tuple(rest)))

    if cfg.attention == "mla":
        kv = [(rows, seq, cfg.kv_lora_rank), (rows, seq, cfg.qk_rope_head_dim)]
    else:
        kv = [(rows, seq, cfg.n_kv_heads, cfg.d_head)] * 2
    remat_times = 2 if cfg.remat else 1
    for _ in range(n_micro):
        leaf(specs["embed"], tuple(shapes["embed"].shape))
        leaf(specs["final_norm"], tuple(shapes["final_norm"].shape))
        if "unembed" in specs:
            leaf(specs["unembed"], tuple(shapes["unembed"].shape))
        for g, (n, _) in enumerate(T.layer_groups(cfg)):
            layer_specs = spec_leaves(_layer_specs(specs["groups"][g]))
            layer_shapes = [tuple(t.shape[1:]) for t in tree_leaves(shapes["groups"][g])]
            for _ in range(n):
                for sp, sh in zip(layer_specs, layer_shapes):
                    leaf(sp, sh, remat_times)
                if n_model > 1:
                    for shape in kv:
                        nbytes = math.prod(shape) * dtype_bytes
                        log.extend([("all-gather", nbytes, n_model, ("model",))] * remat_times)
                        log.append(("reduce-scatter", nbytes, n_model, ("model",)))
    if world > 1:  # the loss, the squared norm
        log += [("all-reduce", 4, world, tuple(mesh.axis_names))] * 2
    if adafactor and world > 1:
        for spec, t in zip(spec_leaves(specs), tree_leaves(shapes)):
            if t.dim() < 2:
                continue
            full = tuple(spec) + (None,) * (t.dim() - len(spec))
            block = shard_shape(tuple(t.shape), spec, mesh)
            last, row = entry_axes(full[-1]), entry_axes(full[-2])
            for axes, shape in ((last, block[:-1]), (row, block[:-2] + block[-1:]), (row, block[:-2])):
                if size(axes) > 1:
                    log.append(("all-reduce", math.prod(shape) * 4, size(axes), axes))
    return log


def schedule_counts(log) -> Counter:
    """A log as a multiset of ``(op, bytes, group size)``."""
    return Counter(tuple(e) for e in log)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def _cache_seq_axes(cache_specs, mesh) -> Tuple[str, ...]:
    """The axes a stacked cache's sequence (dim 2) is split over; raises for
    a cache whose heads are split over more than one device (the sharded
    steps shard the sequence)."""
    spec = cache_specs[0]["c_kv" if "c_kv" in cache_specs[0] else "k"]
    if math.prod(mesh.shape[a] for e in spec[3:] for a in entry_axes(e)) > 1:
        raise NotImplementedError(
            f"cache spec {spec!r} splits the heads; the sharded prefill and decode split "
            "the cache's sequence (kv_cache_pspecs at a model size the kv heads do not divide)")
    return entry_axes(spec[2])


def make_lm_prefill_step(cfg, mesh, specs, cache_specs):
    """``fn(comm, params, caches, tokens) -> (last-position logits (batch /
    n_dp, vocab), caches)``: this device's sequence slice through every
    layer, its keys and values written into its slice of the caches
    (sequence-sharded over ``"model"``), attention over the cache gathered
    whole.  The logits are :func:`transformer.prefill`'s last position."""
    seq_axes = _cache_seq_axes(cache_specs, mesh)

    @torch.no_grad()
    def step(comm, params, caches, tokens):
        lo, hi = _seq_slice(comm, tokens.shape[1], seq_axes)
        device = params["embed"].device
        positions = torch.arange(lo, hi, device=device)
        x, _, embed = _hidden(comm, cfg, specs, params, tokens[:, lo:hi], positions, seq_axes,
                              caches=caches)
        dtype = getattr(torch, cfg.dtype)
        last = (x @ _unembed(comm, params, specs, embed).to(dtype))[:, -1]
        if comm.size(seq_axes) > 1:  # the last position lives on the last slice
            last = comm.gather(last[:, None], P(None, seq_axes))[:, -1]
        return last, caches

    return step


def make_lm_decode_step(cfg, mesh, specs, cache_specs):
    """``fn(comm, params, caches, token, index) -> (logits (b, vocab),
    caches)``: one new token at position ``index`` (an int) against caches
    whose sequence is split (``kv_cache_pspecs``; with ``shard_seq`` over
    every axis, the token replicated).  The device holding ``index`` writes
    the new key and value; every device attends over its slice, and the
    softmax's max, sum and weighted values are combined over the slices."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    seq_axes = _cache_seq_axes(cache_specs, mesh)

    @torch.no_grad()
    def step(comm, params, caches, token, index):
        index = int(index)
        dtype = getattr(torch, cfg.dtype)
        embed = gather_param(comm, params["embed"], specs["embed"])
        x = F.embedding(torch.as_tensor(token, device=embed.device).long(), embed).to(dtype)
        positions = torch.tensor([index], device=embed.device)
        for g, (n, moe) in enumerate(T.layer_groups(cfg)):
            layers = T._map(lambda p: p.unbind(0), params["groups"][g])
            lspecs = _layer_specs(specs["groups"][g])
            for i in range(n):
                layer = T._zip_map(lambda p, sp: gather_param(comm, p[i], sp), layers, lspecs)
                cache = {k: c[i] for k, c in caches[g].items()}
                hn = L.rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
                x = x + _decode_attention(comm, cfg, layer["attn"], hn, positions, index, cache,
                                          seq_axes)
                hn = L.rmsnorm(x, layer["ffn_norm"], cfg.norm_eps)
                h = L.moe_apply(layer["moe"], cfg, hn)[0] if moe else \
                    L.ffn_apply(layer["ffn"], cfg.ffn_activation, hn)
                x = x + h
        x = L.rmsnorm(x, gather_param(comm, params["final_norm"], specs["final_norm"]), cfg.norm_eps)
        return (x @ _unembed(comm, params, specs, embed).to(dtype))[:, -1], caches

    return step


def _decode_attention(comm, cfg, p, x, positions, index, cache, seq_axes):
    """One token's causal attention over a sequence-split cache (split-K):
    GQA over ``k``/``v``, MLA in its absorbed form over the latents."""
    from repro_torch.models import layers as L

    b, _, d = x.shape
    dt = x.dtype
    key = "c_kv" if cfg.attention == "mla" else "k"
    s_local = cache[key].shape[1]
    lo = _seq_slice(comm, s_local * comm.size(seq_axes), seq_axes)[0]
    valid = (torch.arange(lo, lo + s_local, device=x.device) <= index)  # (s_local,)

    def write(name, value):  # value (b, 1, ...): only the slice holding index writes
        if lo <= index < lo + s_local:
            cache[name][:, index - lo] = value[:, 0].to(cache[name].dtype)

    def combine(logits, values):
        """softmax(logits) @ values over every slice: logits (..., s_local)
        fp32, values (b, s_local, ...) -> (..., e)."""
        logits = torch.where(valid, logits, -1e30)
        m = comm.all_reduce(logits.amax(-1), seq_axes, op="max")
        w = torch.exp(logits - m[..., None]) * valid
        num = values(w)
        den = comm.all_reduce(w.sum(-1), seq_axes)
        return comm.all_reduce(num, seq_axes) / den[..., None]

    if cfg.attention == "mla":
        h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q = (x @ p["w_q"].to(dt).reshape(d, -1)).view(b, 1, h, dn + dr)
        q_nope, q_rope = q[..., :dn], L.apply_rope(q[..., dn:], positions, cfg.rope_theta)
        c_kv = L.rmsnorm(x @ p["w_dkv"].to(dt), p["kv_norm"], cfg.norm_eps)
        k_rope = L.apply_rope((x @ p["w_krope"].to(dt))[:, :, None], positions, cfg.rope_theta)[:, :, 0]
        write("c_kv", c_kv)
        write("k_rope", k_rope)
        c_all, r_all = cache["c_kv"].float(), cache["k_rope"].float()
        q_lat = torch.einsum("bhe,rhe->bhr", q_nope[:, 0].float(), p["w_uk"].float())
        logits = (q_lat @ c_all.transpose(1, 2) + q_rope[:, 0].float() @ r_all.transpose(1, 2))
        out_lat = combine(logits * (1.0 / math.sqrt(dn + dr)), lambda w: w @ c_all)  # (b, h, r)
        out = torch.einsum("bhr,rhe->bhe", out_lat, p["w_uv"].float()).to(dt)
        return out.reshape(b, 1, -1) @ p["w_o"].to(dt).reshape(-1, d)

    e, h_kv = cfg.d_head, cfg.n_kv_heads

    def project(w):
        return (x @ w.to(dt).reshape(d, -1)).view(b, 1, -1, e)

    q = L.apply_rope(project(p["w_q"]), positions, cfg.rope_theta)
    write("k", L.apply_rope(project(p["w_k"]), positions, cfg.rope_theta))
    write("v", project(p["w_v"]))
    k, v = cache["k"].float(), cache["v"].float()  # (b, s_local, h_kv, e)
    qg = q[:, 0].float().reshape(b, h_kv, -1, e)
    logits = torch.einsum("bhge,bshe->bhgs", qg, k) * (1.0 / math.sqrt(e))
    out = combine(logits, lambda w: torch.einsum("bhgs,bshe->bhge", w, v))
    return out.reshape(b, 1, -1).to(dt) @ p["w_o"].to(dt).reshape(-1, d)
