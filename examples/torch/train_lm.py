"""End to end: train a ~100M-parameter LM for a few hundred steps
with the whole training substrate (AdamW with a warmup-cosine schedule,
checkpoints, the straggler watchdog, a deterministic resumable token
stream), on the port.

The PyTorch counterpart of ``examples/train_lm.py``: the same configs,
schedule, data and final check that the loss fell.  Runs on the CUDA card
unless told otherwise:

  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300]     # the card
  PYTHONPATH=src python examples/torch/train_lm.py --tiny --device cpu
"""

import argparse
import tempfile

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.data.pipeline import token_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.optimizer import adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from repro_torch.train.tree import tree_leaves, tree_map


def make_config(tiny: bool) -> LMConfig:
    if tiny:
        return LMConfig(
            name="lm-tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
            d_head=32, d_ff=512, vocab_size=2048, dtype="float32", remat=False,
            attn_q_chunk=128, scan_layers=False,
        )
    # ~100M params: 12L x 512d, GQA 8/4, vocab 32k
    return LMConfig(
        name="lm-100m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
        d_head=64, d_ff=2048, vocab_size=32768, dtype="float32", remat=False,
        attn_q_chunk=256, scan_layers=True,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config(args.tiny)
    params = T.init_params(cfg, seed=0, device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name} — {n_params / 1e6:.1f}M parameters")

    lr_fn = linear_warmup_cosine(3e-4, warmup=20, total_steps=args.steps)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}

    def train_step(state, batch):
        tokens, labels = batch
        params = state["params"]
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss = T.loss_fn(params, cfg, tokens, labels)
        loss.backward()
        grads, gnorm = clip_by_global_norm(tree_map(lambda p: p.grad, params), 1.0)
        params, opt = adamw_update(grads, state["opt"], params, lr_fn(state["step"]))
        return (
            {"params": params, "opt": opt, "step": state["step"] + 1},
            {"loss": loss.detach(), "gnorm": gnorm},
        )

    def data_factory(start):
        return token_batches(cfg, args.batch, args.seq_len, seed=0, start_step=start, device=device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop = TrainLoop(
            LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=100,
                       log_every=max(args.steps // 20, 1)),
            train_step,
            data_factory,
            state,
        )
        loop.run()
    hist = loop.metrics_history
    print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over {args.steps} steps")
    assert hist[-1]["loss"] < hist[0]["loss"], "training did not reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
