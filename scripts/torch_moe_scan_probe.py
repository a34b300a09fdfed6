"""Time two ways to compute the MoE pairs' queue positions on one CUDA card.

The ``(t*k, e)`` one-hot scanned down its pair axis against the flat scan
of the expert-major one-hot (``repro_torch.models.layers.moe_apply``), in
turns (outer, flat, flat, outer), at DeepSeek-V2-Lite's and DBRX's
forward shapes (b=4, s=4096: 98,304 pairs over 64 experts, 65,536 over
16); both must give the same positions.  Then ``chip_smoke.py``'s
``[mla_moe]`` phase.  ``--out f.json`` also writes the whole record.

    python3 scripts/torch_moe_scan_probe.py [--out f.json]   # on a machine with a CUDA card
"""
import argparse, json, sys
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT)); sys.path.insert(0, str(ROOT / "src"))
import torch
import chip_smoke as C

def outer(flat_e, e):
    onehot = (flat_e[:, None] == torch.arange(e, device=flat_e.device)).long()
    return (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat_e[:, None])[:, 0]

def flat(flat_e, e):
    onehot = (torch.arange(e, device=flat_e.device)[:, None] == flat_e).int()
    counts = onehot.sum(1)
    run = torch.cumsum(onehot.view(-1), 0, dtype=torch.int32).view(e, -1)
    return run.gather(0, flat_e[None])[0] - 1 - (torch.cumsum(counts, 0) - counts)[flat_e]

def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the full record to this JSON file")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    print(C.card_line(), flush=True)
    rows = []
    for name, n_pairs, e in (("deepseek", 16384 * 6, 64), ("dbrx", 16384 * 4, 16)):
        g = torch.Generator(device=dev).manual_seed(0)
        flat_e = torch.randint(0, e, (n_pairs,), generator=g, device=dev)
        if not torch.equal(outer(flat_e, e), flat(flat_e, e).long()):
            raise AssertionError(f"{name}: the two scans give different queue positions")
        t = [C.time_ms(lambda: outer(flat_e, e), 5), C.time_ms(lambda: flat(flat_e, e), 5),
             C.time_ms(lambda: flat(flat_e, e), 5), C.time_ms(lambda: outer(flat_e, e), 5)]
        rows.append({"shape": name, "pairs": n_pairs, "experts": e, "outer_ms": [t[0], t[3]],
                     "flat_ms": [t[1], t[2]]})
        print(f"[scan] {json.dumps(rows[-1])}", flush=True)
    C.build_kernels()
    from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as MLA
    rec, params, _ = C.mla_moe_path(MLA, dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"scan": rows, "mla_moe": rec}, indent=1))

if __name__ == "__main__":
    main()
