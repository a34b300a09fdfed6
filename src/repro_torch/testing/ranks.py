"""Run a function on every rank of a fresh ``torch.distributed`` group.

:func:`run_ranks` spawns ``world_size`` processes (the ``spawn`` start
method), joins them into one group through a ``FileStore`` under a fresh
temporary directory (no TCP port to collide with another run), calls
``fn(rank, world_size, *args)`` in each, and returns the per-rank results in
rank order.  Every group gets ``timeout=`` in ``init_process_group``, and the
whole run its own wall-clock limit: a hung collective raises here, in the
caller, and every process is stopped.  ``fn`` and its results must pickle,
so ``fn`` is a module-level function of an importable module.

The mesh tests, the distributed example and ``chip_smoke.py`` launch their
ranks through it: gloo on the CPU, NCCL with one rank per card
(``torch.cuda.set_device(rank)`` before ``fn``).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence

__all__ = ["run_ranks", "RankFailed"]


class RankFailed(RuntimeError):
    """A rank raised (its traceback is in the message), or the run missed its
    wall-clock limit."""


def _rank_main(fn, rank, world_size, init_method, backend, timeout_s, args, results):
    import torch
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        kwargs = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kwargs["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world_size,
            timeout=timedelta(seconds=timeout_s), **kwargs,
        )
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(
    fn: Callable,
    world_size: int,
    args: Sequence[Any] = (),
    *,
    backend: str = "gloo",
    timeout_s: float = 120.0,
) -> List[Any]:
    """``[fn(0, world_size, *args), ..., fn(world_size - 1, ...)]``, each in
    its own process of one ``backend`` group.  Raises :class:`RankFailed`
    if a rank raises or the run takes longer than ``timeout_s`` seconds
    (the group's collectives time out after the same)."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, rank, world_size, init_method, backend, timeout_s, tuple(args), results),
            daemon=True,
        )
        for rank in range(world_size)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got = {}
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankFailed(
                    f"{world_size} ranks of {getattr(fn, '__name__', fn)} did not finish in "
                    f"{timeout_s:.0f} s (ranks done: {sorted(got)})"
                )
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(got) < world_size:
                    # a rank died without reporting (killed, or a crash in
                    # native code): the others would wait out the timeout
                    raise RankFailed(
                        f"rank process exited with code {dead[0].exitcode} before reporting"
                    )
                continue
            if not ok:
                raise RankFailed(f"rank {rank} raised:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
