"""Training launcher CLI.

Runs a real training job for a registered LM, GNN or recsys arch on one
device,
through the whole substrate: the config registry, the synthetic data,
AdamW with global-norm clipping, checkpoint/restart and the straggler
watchdog.  The train step is plain eager PyTorch: zero the gradients,
``loss_fn``, ``backward``, clip, update in place.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke \\
      --steps 50 --batch 8 --seq-len 128 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch two-tower-retrieval \
      --smoke --steps 10 --device cpu

Without ``--device`` the job runs on the CUDA card and fails without one.
The mesh cells of the multi-card tooling (sharded steps, the dry run) are
``repro_torch.launch.cells`` and ``python -m repro_torch.launch.dryrun``.
"""

from __future__ import annotations

import argparse
import sys
import time


def make_lm_job(cfg, batch: int, seq_len: int, lr: float, device=None, loss_chunk: int = 0):
    """``(state, train_step, data_factory)`` of an LM job on ``device``
    (``None``: the card): ``state`` is ``{"params", "opt"}`` (fp32
    parameters from ``init_params(cfg, seed=0)`` and their AdamW state),
    ``train_step(state, (tokens, labels))`` returns ``(state, {"loss",
    "gnorm"})`` with the state updated in place, and ``data_factory(step)``
    is the token stream from ``step`` on.  A caller may put other
    parameters into ``state`` (with ``adamw_init`` of them) before the
    first step.  ``loss_chunk`` is ``loss_fn``'s (the launch tooling's
    cells use 512)."""
    from repro_torch.data.pipeline import token_batches
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw_init, adamw_update, clip_by_global_norm
    from repro_torch.train.tree import tree_leaves, tree_map

    device = resolve_device(device)
    params = T.init_params(cfg, seed=0, device=device)
    state = {"params": params, "opt": adamw_init(params)}

    def train_step(state, batch_data):
        tokens, labels = batch_data
        params = state["params"]
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss = T.loss_fn(params, cfg, tokens, labels, loss_chunk=loss_chunk)
        loss.backward()
        grads, gnorm = clip_by_global_norm(tree_map(lambda p: p.grad, params), 1.0)
        params, opt = adamw_update(grads, state["opt"], params, lr)
        return {"params": params, "opt": opt}, {"loss": loss.detach(), "gnorm": gnorm}

    def data_factory(start_step):
        return token_batches(cfg, batch, seq_len, seed=0, start_step=start_step, device=device)

    return state, train_step, data_factory


def gnn_train_step(cfg, lr: float):
    """The GNN train step ``train_step(state, (batch, labels))`` ->
    ``(state, {"loss", "gnorm"})``, written as :func:`make_lm_job`'s: zero
    the gradients, ``loss_fn``, ``backward``, clip to global norm 1, AdamW
    in place.  A leaf the loss does not reach (NequIP's and MACE's last l>0
    mixes) gets a zero gradient, as under ``jax.grad``."""
    import torch

    from repro_torch.models import gnn as G
    from repro_torch.train.optimizer import adamw_update, clip_by_global_norm
    from repro_torch.train.tree import tree_leaves, tree_map

    def train_step(state, batch_data):
        gb, labels = batch_data
        params = state["params"]
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss = G.loss_fn(params, cfg, gb, labels)
        loss.backward()
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        params, opt = adamw_update(grads, state["opt"], params, lr)
        return {"params": params, "opt": opt}, {"loss": loss.detach(), "gnorm": gnorm}

    return train_step


def make_gnn_job(cfg, batch: int, lr: float, device=None):
    """``(state, train_step, data_factory)`` of a GNN job on ``device``
    (``None``: the card), as the reference's: one fixed
    ``graph_batch_from_shape(64, 128, 16, batch_graphs=max(batch // 16,
    1))`` batch, class labels for GCN/GAT and zero energies for
    NequIP/MACE, parameters from ``init_model(cfg, 16, seed=0)`` and
    :func:`gnn_train_step`."""
    import torch

    from repro_torch.data.pipeline import graph_batch_from_shape
    from repro_torch.device import resolve_device
    from repro_torch.models import gnn as G
    from repro_torch.train.optimizer import adamw_init

    device = resolve_device(device)
    d_feat = 16
    gb, labels = graph_batch_from_shape(64, 128, d_feat, seed=0, batch_graphs=max(batch // 16, 1),
                                        device=device)
    if cfg.model in ("nequip", "mace"):
        labels = torch.zeros((gb.n_graphs,), dtype=torch.float32, device=device)
    params = G.init_model(cfg, d_feat, seed=0, device=device)
    state = {"params": params, "opt": adamw_init(params)}

    def data_factory(start_step):
        def gen():
            while True:
                yield (gb, labels)
        return gen()

    return state, gnn_train_step(cfg, lr), data_factory


def make_recsys_job(cfg, batch: int, lr: float, device=None):
    """``(state, train_step, data_factory)`` of a two-tower job on
    ``device`` (``None``: the card), as the reference's: parameters from
    ``init_params(cfg, seed=0)``, AdamW with global-norm clipping at 1.0,
    and ``click_batches(cfg, batch, seed=0)`` from the start step.  The
    step is :func:`make_lm_job`'s: eager, updating the state in place."""
    from repro_torch.data.pipeline import click_batches
    from repro_torch.device import resolve_device
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw_init, adamw_update, clip_by_global_norm
    from repro_torch.train.tree import tree_leaves, tree_map

    device = resolve_device(device)
    params = R.init_params(cfg, seed=0, device=device)
    state = {"params": params, "opt": adamw_init(params)}

    def train_step(state, batch_data):
        uix, iix, log_q = batch_data
        params = state["params"]
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss = R.loss_fn(params, cfg, uix, iix, log_q)
        loss.backward()
        grads, gnorm = clip_by_global_norm(tree_map(lambda p: p.grad, params), 1.0)
        params, opt = adamw_update(grads, state["opt"], params, lr)
        return {"params": params, "opt": opt}, {"loss": loss.detach(), "gnorm": gnorm}

    def data_factory(start_step):
        return click_batches(cfg, batch, seed=0, start_step=start_step, device=device)

    return state, train_step, data_factory


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced SMOKE_CONFIG")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch
    from repro_torch.train.loop import LoopConfig, TrainLoop

    family, module = get_arch(args.arch)
    cfg = module.SMOKE_CONFIG if args.smoke else module.CONFIG
    if family == "lm":
        state, step, data = make_lm_job(cfg, args.batch, args.seq_len, args.lr, device=args.device)
    elif family == "gnn":
        state, step, data = make_gnn_job(cfg, args.batch, args.lr, device=args.device)
    elif family == "recsys":
        state, step, data = make_recsys_job(cfg, args.batch, args.lr, device=args.device)
    else:
        raise SystemExit(f"train launcher does not support family {family}")

    loop = TrainLoop(
        LoopConfig(
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            log_every=max(args.steps // 10, 1),
        ),
        step,
        data,
        state,
    )
    resumed = loop.try_restore()
    print(f"arch={args.arch} family={family} resumed={resumed} start_step={loop.step}")
    t0 = time.monotonic()
    loop.run()
    dt = time.monotonic() - t0
    hist = loop.metrics_history
    print(f"done {args.steps} steps in {dt:.1f}s; loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    if loop.straggler_events:
        print(f"straggler events: {len(loop.straggler_events)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
