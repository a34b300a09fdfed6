"""Does a gather's backward repeat bit for bit on one CUDA card?

For each case (a table, an index drawn as the port's data streams draw it,
a random output gradient), the table's gradient is computed twice through
``F.embedding`` (torch's own backward), twice through
``repro_torch.models.recsys._Gather`` (a stable sort, then
``torch.segment_reduce``), and twice through ``F.embedding`` under
``torch.use_deterministic_algorithms(True)``; each pair must be equal bit
for bit to print ``True``.  The cases: the two-tower click stream's fields
at vocabularies of 100, 1,000 and 100,000 rows (b=4,096 and 65,536 bags of
4), and granite-8b's token batch (``token_batches``, b=2 x s=4,096, its
49,152 x 4,096 table).  Prints one JSON line per case and the card's
name and power limit.

    python3 scripts/torch_embedding_repeat_probe.py   # on a machine with a CUDA card
"""
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs.granite_8b import CONFIG as GRANITE  # noqa: E402
from repro_torch.configs.two_tower_retrieval import CONFIG as TWO_TOWER  # noqa: E402
from repro_torch.data.pipeline import click_batches, token_batches  # noqa: E402
from repro_torch.models.recsys import _Gather  # noqa: E402


def grads(table, idx, grad_out, gather) -> torch.Tensor:
    t = table.clone().requires_grad_(True)
    gather(t, idx).backward(grad_out)
    return t.grad


def repeats(table, idx, grad_out, gather, deterministic=False) -> bool:
    torch.use_deterministic_algorithms(deterministic)
    try:
        return torch.equal(grads(table, idx, grad_out, gather), grads(table, idx, grad_out, gather))
    finally:
        torch.use_deterministic_algorithms(False)


def main(dev=torch.device("cuda", 0)) -> int:
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for rows in (100, 1_000, 100_000):
        for batch in (4_096, 65_536):
            cfg = dataclasses.replace(TWO_TOWER, item_vocab_sizes=(rows,) * TWO_TOWER.n_item_fields)
            idx = next(click_batches(cfg, batch, seed=0, device=dev))[1][:, 0]
            cases.append((f"click field, {rows} rows, {batch} bags of 4", idx, rows, cfg.embed_dim))
    tokens = next(token_batches(GRANITE, 2, 4096, seed=0, device=dev))[0]
    cases.append(("granite-8b tokens, b=2 x s=4096", tokens, GRANITE.vocab_size, GRANITE.d_model))
    for name, idx, rows, d in cases:
        table = torch.randn((rows, d), generator=gen, device=dev) * 0.01
        grad_out = torch.randn((*idx.shape, d), generator=gen, device=dev)
        distinct = torch.unique(idx, return_counts=True)[1]
        print(json.dumps({
            "case": name, "indices": idx.numel(), "distinct": distinct.numel(),
            "most_repeated": int(distinct.max()),
            "embedding_bitwise": repeats(table, idx, grad_out, lambda t, i: F.embedding(i, t)),
            "fixed_order_gather_bitwise": repeats(table, idx, grad_out, _Gather.apply),
            "embedding_deterministic_mode_bitwise": repeats(
                table, idx, grad_out, lambda t, i: F.embedding(i, t), deterministic=True),
        }), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
