"""Carry state across from the JAX reference package.

What the two packages must share to compare like with like: for counting,
the graph and the colorings; for the models, the parameters.  This
module takes plain numpy arrays (never a ``repro`` object's methods), so
the port still imports nothing of the reference; a caller holding a
reference ``Graph`` passes its ``(n, src, dst)``, and one holding reference
LM, GNN or recsys parameters passes ``jax.tree.map(np.asarray, params)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph

__all__ = [
    "graph_from_arrays",
    "colorings_to_tensor",
    "lm_params_from_numpy",
    "gnn_params_from_numpy",
    "recsys_params_from_numpy",
]


def graph_from_arrays(n: int, src, dst) -> Graph:
    """The port's :class:`Graph` from a reference graph's ``(n, src, dst)``.

    The arrays must already be in canonical form (both directions, sorted
    by ``(dst, src)``), as every reference ``Graph`` is; that is checked,
    not repaired, so the two packages hash and count the same edges.
    """
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src and dst must be 1-D arrays of equal length")
    if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n):
        raise ValueError(f"edge endpoints outside [0, {n})")
    key = dst.astype(np.int64) * max(int(n), 1) + src
    if np.any(np.diff(key) <= 0):
        raise ValueError("edges are not sorted by (dst, src) without duplicates")
    return Graph(n=int(n), src=src, dst=dst)


def colorings_to_tensor(colors, device) -> torch.Tensor:
    """``(iters, n)`` (or ``(n,)``) integer numpy colorings -> int64 tensor
    on ``device``."""
    colors = np.asarray(colors)
    if not np.issubdtype(colors.dtype, np.integer):
        raise TypeError(f"colorings must be integers, got {colors.dtype}")
    return torch.as_tensor(colors.astype(np.int64), device=torch.device(device))


def _params_like(want, params_np, device):
    """``params_np`` (nested dicts and lists of numpy arrays) as fp32
    tensors on ``device``, checked path by path against the tree of
    ``meta`` tensors ``want``: the first path whose keys, length or shape
    differ raises ``ValueError``."""
    device = torch.device(device)

    def convert(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                have = sorted(got) if isinstance(got, dict) else type(got).__name__
                raise ValueError(f"{path or 'params'}: keys {have} != {sorted(want)}")
            return {k: convert(want[k], got[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(f"{path}: expected a list of {len(want)} groups")
            return [convert(w, g, f"{path}[{i}]") for i, (w, g) in enumerate(zip(want, got))]
        arr = np.asarray(got)
        if arr.shape != tuple(want.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(want.shape)}")
        return torch.as_tensor(arr.astype(np.float32), device=device)

    return convert(want, params_np, "")


def lm_params_from_numpy(params_np, cfg, device):
    """The reference's LM parameter tree (nested dicts and lists of numpy
    arrays) as the port's fp32 parameters on ``device``.

    The tree must have exactly the keys and shapes of
    :func:`repro_torch.models.transformer.param_shapes` for ``cfg``;
    anything else raises ``ValueError`` naming the first offending path.
    """
    from repro_torch.models.transformer import param_shapes

    return _params_like(param_shapes(cfg), params_np, device)


def gnn_params_from_numpy(params_np, cfg, device):
    """The reference's GNN parameter tree (dicts and lists of numpy arrays,
    from ``repro.models.gnn.init_model``) as the port's fp32 parameters on
    ``device``.

    The input width ``d_in`` is read from the first layer's weight
    (``layers[0]/w`` for GCN/GAT, ``embed[0]/w`` for NequIP/MACE); then the
    tree must have exactly the keys and shapes of
    :func:`repro_torch.models.gnn.param_shapes` for ``cfg`` and ``d_in``;
    anything else raises ``ValueError`` naming the first offending path.
    """
    from repro_torch.models.gnn import param_shapes

    first = ("layers", 0, "w") if cfg.model in ("gcn", "gat") else ("embed", 0, "w")
    try:
        leaf = params_np
        for k in first:
            leaf = leaf[k]
        d_in = int(np.shape(leaf)[0])
    except (KeyError, IndexError, TypeError) as e:
        path = "/".join(map(str, first))
        raise ValueError(f"{cfg.model} parameters need a weight at {path}") from e
    return _params_like(param_shapes(cfg, d_in), params_np, device)


def recsys_params_from_numpy(params_np, cfg, device, vocab_scale: float = 1.0):
    """The reference's two-tower parameter tree (from
    ``repro.models.recsys.init_params(key, cfg, vocab_scale)``) as the
    port's fp32 parameters on ``device``.

    The tree must have exactly the keys and shapes of
    :func:`repro_torch.models.recsys.param_shapes` for ``cfg`` and
    ``vocab_scale``; anything else raises ``ValueError`` naming the first
    offending path.
    """
    from repro_torch.models.recsys import param_shapes

    return _params_like(param_shapes(cfg, vocab_scale), params_np, device)
