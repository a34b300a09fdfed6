"""Probe what the mesh backend's collectives can use on one CUDA card.

Prints, for the installed torch: whether ``torch.segment_reduce`` (the mesh
path's fixed-order segment sum) repeats bitwise on the card, whether a
one-rank NCCL group runs ``all_gather_into_tensor`` and ``all_reduce``, and
what gloo does with CUDA tensors at 4 ranks sharing ``cuda:0`` (the
all-gather, a ``batch_isend_irecv`` ring hop, the all-reduce).  A failing
gloo operation may abort its rank's process: that is the answer.

    python3 scripts/torch_mesh_probe.py      # on a machine with a CUDA card
"""
import os, sys, tempfile, time, traceback
from datetime import timedelta
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def gloo_rank(rank, world, init, q):
    out = {}
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        dev = torch.device("cuda", 0)
        x = torch.full((4, 3), float(rank), device=dev)
        for name, fn in (
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(4 * world, 3, device=dev), x)),
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("ring", lambda: [r.wait() for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % world),
                dist.P2POp(dist.irecv, torch.empty_like(x), (rank - 1) % world)])]),
            ("all_gather_bf16", lambda: dist.all_gather_into_tensor(
                torch.empty(4 * world, 3, device=dev, dtype=torch.bfloat16), x.bfloat16())),
        ):
            try:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out[name] = f"ok {time.perf_counter() - t0:.4f}s"
            except Exception as exc:
                out[name] = f"FAIL {type(exc).__name__}: {str(exc)[:300]}"
        # correctness of the gather
        try:
            g = torch.empty(4 * world, 3, device=dev)
            dist.all_gather_into_tensor(g, x)
            out["gather_values"] = g[::4, 0].tolist()
            nxt = torch.empty_like(x)
            for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % world),
                                             dist.P2POp(dist.irecv, nxt, (rank - 1) % world)]):
                r.wait()
            out["ring_value"] = float(nxt[0, 0])
        except Exception as exc:
            out["values"] = f"FAIL {exc}"
        dist.destroy_process_group()
    except Exception:
        out["init"] = traceback.format_exc()[-800:]
    q.put((rank, out))


def main():
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          torch.cuda.device_count(), flush=True)
    dev = torch.device("cuda", 0)
    # segment_reduce determinism, bucket-sum shape
    g = torch.Generator(device="cpu").manual_seed(0)
    lengths = torch.randint(0, 60, (200_000,), generator=g)
    lengths[7] = 40000
    e = int(lengths.sum())
    vals = torch.randn(e, 4, 128, generator=g).to(dev)
    L = lengths.to(dev)
    a = torch.segment_reduce(vals, "sum", lengths=L, axis=0)
    b = torch.segment_reduce(vals, "sum", lengths=L, axis=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        torch.segment_reduce(vals, "sum", lengths=L, axis=0)
    torch.cuda.synchronize()
    print("segment_reduce bitwise repeat:", torch.equal(a, b), "ms", (time.perf_counter() - t0) / 5 * 1e3,
          "E", e, flush=True)
    ref = torch.zeros(200_000, 4, 128, device=dev).index_add_(
        0, torch.repeat_interleave(torch.arange(200_000, device=dev), L), vals)
    print("vs index_add max abs", float((a - ref).abs().max()), flush=True)
    # index_add with unique indices deterministic anyway; check 1-D cub path too
    a1 = torch.segment_reduce(vals[:, 0, 0].contiguous(), "sum", lengths=L, axis=0)
    b1 = torch.segment_reduce(vals[:, 0, 0].contiguous(), "sum", lengths=L, axis=0)
    print("1-D repeat", torch.equal(a1, b1), flush=True)
    # NCCL at world 1
    d = tempfile.mkdtemp()
    try:
        dist.init_process_group("nccl", init_method=f"file://{d}/nccl1", rank=0, world_size=1,
                                timeout=timedelta(seconds=60), device_id=dev)
        x = torch.arange(12., device=dev).reshape(4, 3)
        o = torch.empty(4, 3, device=dev)
        dist.all_gather_into_tensor(o, x)
        y = x.clone(); dist.all_reduce(y)
        torch.cuda.synchronize()
        print("nccl world1 ok", torch.equal(o, x), torch.equal(y, x), flush=True)
        dist.destroy_process_group()
    except Exception:
        print("nccl world1 FAIL", traceback.format_exc()[-600:], flush=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{d}/gloo4"
    ps = [ctx.Process(target=gloo_rank, args=(r, 4, init, q)) for r in range(4)]
    t0 = time.perf_counter()
    for p in ps:
        p.start()
    res = {}
    deadline = time.perf_counter() + 240
    while len(res) < 4 and time.perf_counter() < deadline:
        try:
            r, out = q.get(timeout=1.0)
            res[r] = out
        except Exception:  # queue.Empty: a rank may have aborted
            if all(p.exitcode is not None for p in ps):
                break
    for p in ps:
        p.join(5)
        if p.is_alive():
            p.kill()
    print("exit codes", [p.exitcode for p in ps], flush=True)
    print("gloo 4 ranks on cuda:0 in", time.perf_counter() - t0, "s", flush=True)
    for r in sorted(res):
        print("rank", r, res[r], flush=True)


if __name__ == "__main__":
    main()
