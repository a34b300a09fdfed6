"""Serving example: batched request serving with the continuous-batching
engine (prefill into slots + joint decode), on the port.

The PyTorch counterpart of ``examples/serve_lm.py``: the same config,
requests and check that every request finished.  Runs on the CUDA card
unless told otherwise:

  PYTHONPATH=src python examples/torch/serve_lm.py               # the card
  PYTHONPATH=src python examples/torch/serve_lm.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.configs.base import LMConfig
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    cfg = LMConfig(
        name="serve-demo", n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
        d_head=32, d_ff=1024, vocab_size=4096, dtype="float32", remat=False,
        attn_q_chunk=64, scan_layers=False,
    )
    params = T.init_params(cfg, seed=7, device=args.device)
    engine = ServeEngine(cfg, params, max_batch=4, max_len=96)

    rng = np.random.default_rng(0)
    requests = [
        Request(uid=i, prompt=rng.integers(1, cfg.vocab_size, size=int(l)).astype(np.int32),
                max_new_tokens=12)
        for i, l in enumerate(rng.integers(4, 24, size=10))
    ]
    print(f"serving {len(requests)} requests on a {engine.max_batch}-slot pool on {engine.device}...")
    engine.run(requests)
    for req in requests:
        assert req.done and len(req.generated) == 12
        print(f"  req {req.uid}: prompt_len={len(req.prompt)} -> {req.generated}")
    print("OK — all requests served to completion with continuous batching")


if __name__ == "__main__":
    main()
