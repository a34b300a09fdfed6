"""Atomic, asynchronous checkpoints in the reference's on-disk layout.

Layout: ``<dir>/step_<N:08d>/`` holding ``arrays.npz`` (leaf ``i`` of the
tree as ``leaf_i``, in ``jax.tree.flatten``'s order: dict keys sorted,
sequence and ``NamedTuple`` fields in order) and ``manifest.json``.
Writes go to a ``.tmp`` directory and an atomic rename, so a crash
mid-write never corrupts the latest checkpoint; ``restore_latest`` skips
incomplete step directories.  Either package restores the other's
checkpoints.  ``AsyncCheckpointer`` copies the tree to the host before it
returns and writes it from a background thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest", "AsyncCheckpointer"]

_MANIFEST = "manifest.json"


def _to_host(x) -> np.ndarray:
    """A host copy that later in-place updates of ``x`` cannot reach."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def save_checkpoint(directory: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    """Atomic write of a tree checkpoint; returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves, _ = tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_host(leaf) for i, leaf in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "n_leaves": len(arrays), "time": time.time(), "extra": extra or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _like(arr: np.ndarray, want):
    """A restored leaf as ``want`` holds it: a tensor on ``want``'s device for
    a tensor, else the numpy array."""
    return torch.as_tensor(arr).to(want.device) if torch.is_tensor(want) else arr


def restore_checkpoint(path: str, tree_like) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (shapes must match)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves, treedef = tree_flatten(tree_like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, model has {len(leaves)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for got, want in zip(restored, leaves):
        if got.shape != tuple(np.shape(want)):
            raise ValueError(f"shape mismatch: checkpoint {got.shape} vs model {tuple(np.shape(want))}")
    return tree_unflatten(treedef, [_like(a, w) for a, w in zip(restored, leaves)]), manifest


def restore_latest(directory: str, tree_like) -> Optional[Tuple[Any, Dict]]:
    """Most recent *complete* checkpoint, or None."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, _MANIFEST))
    )
    if not steps:
        return None
    return restore_checkpoint(os.path.join(directory, steps[-1]), tree_like)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one write in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        self.wait()
        host_tree = tree_map(_to_host, tree)  # device -> host before the thread starts

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
