"""Roofline terms of a dry-run cell on the H100's constants.

Three terms per (arch x shape x mesh), in seconds, per device:

    compute    = FLOPs / peak FLOP/s for the cell's dtype
    memory     = bytes accessed / HBM bandwidth
    collective = sum over collectives of wire bytes / the link its group crosses

The constants are NVIDIA's datasheet figures for the H100 SXM5 80GB, not
measurements: they bound what a device could do, and ``chip_smoke.py``
``[launch]`` prints a measured step beside them.

Collectives are ring-costed as in the reference (wire bytes per device):

    all-reduce:      2 * (G-1)/G * bytes
    all-gather:          (G-1)/G * bytes   (of the gathered output)
    reduce-scatter:      (G-1)/G * bytes   (of the input)
    all-to-all:          (G-1)/G * bytes
    collective-permute:  bytes

over a log of ``(op, bytes, group size[, axes])`` records (the sharded
executor's :class:`~repro_torch.launch.sharded.Comm` log, or a cell's
analytic schedule) in place of the reference's HLO text.  A group is
priced at NVLink if its devices sit in one 8-GPU node (devices numbered
row-major over the mesh, 8 to a node), else at the inter-node link.
"""

from __future__ import annotations

import itertools
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "PEAK_FLOPS_BF16",
    "PEAK_FLOPS_FP32",
    "HBM_BW",
    "HBM_BYTES",
    "NVLINK_BW",
    "INTER_NODE_BW",
    "GPUS_PER_NODE",
    "peak_flops",
    "link_bandwidth",
    "collective_wire_bytes",
    "collective_seconds",
    "RooflineReport",
    "analyze",
]

# H100 SXM5 80GB datasheet (NVIDIA, dense rates, no sparsity)
PEAK_FLOPS_BF16 = 989e12   # bf16 / fp16 tensor core
PEAK_FLOPS_FP32 = 67e12    # fp32 outside the tensor cores
HBM_BW = 3.35e12           # HBM3, bytes/s
HBM_BYTES = 80e9           # HBM3 capacity
# NVLink 4: 900 GB/s per GPU bidirectional, so 450 GB/s each way, between
# the 8 GPUs of an HGX H100 node (NVSwitch)
NVLINK_BW = 450e9
# between nodes: one 400 Gb/s NDR InfiniBand adapter per GPU (HGX H100
# reference design), 50 GB/s each way
INTER_NODE_BW = 50e9
GPUS_PER_NODE = 8


def peak_flops(dtype: str) -> float:
    """The datasheet peak for a cell computing in ``dtype``."""
    return PEAK_FLOPS_BF16 if dtype in ("bfloat16", "float16") else PEAK_FLOPS_FP32


def link_bandwidth(mesh, axes: Sequence[str]) -> float:
    """Bytes/s of the slowest link a group over ``axes`` crosses: the
    group of device 0 (every group over the same axes has the same span
    when the node size divides the mesh's trailing extent or is a multiple
    of it, as on the production meshes)."""
    names = list(mesh.shape)
    sizes = [mesh.shape[a] for a in names]
    strides = [1] * len(names)
    for i in range(len(names) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    ranges = [range(mesh.shape[a]) if a in axes else range(1) for a in names]
    nodes = {sum(c * s for c, s in zip(coords, strides)) // GPUS_PER_NODE
             for coords in itertools.product(*ranges)}
    return NVLINK_BW if len(nodes) == 1 else INTER_NODE_BW


def _wire(op: str, nbytes: float, g: int) -> Optional[float]:
    if g <= 1 and op != "collective-permute":
        return None
    frac = (g - 1) / g if g > 1 else 1.0
    if op == "all-reduce":
        return 2.0 * frac * nbytes
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return frac * nbytes
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


def collective_wire_bytes(log: Iterable[Sequence]) -> Tuple[float, Dict[str, int]]:
    """Ring-costed wire bytes per device over ``(op, bytes, group size,
    ...)`` records, and the count of each op."""
    total = 0.0
    counts: Dict[str, int] = {}
    for rec in log:
        op, nbytes, g = rec[0], rec[1], int(rec[2])
        w = _wire(op, nbytes, g)
        if w is None:
            continue
        total += w
        counts[op] = counts.get(op, 0) + 1
    return total, counts


def collective_seconds(log: Iterable[Sequence], mesh) -> float:
    """Each record's wire bytes over its group's link (records carry their
    axes as a fourth field; without one, the slowest link)."""
    total = 0.0
    for rec in log:
        w = _wire(rec[0], rec[1], int(rec[2]))
        if w is None:
            continue
        bw = link_bandwidth(mesh, rec[3]) if len(rec) > 3 else INTER_NODE_BW
        total += w / bw
    return total


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops: float            # per device (the port counts a trace, not HLO)
    hlo_bytes: float            # per device
    collective_bytes: float     # wire bytes per device (ring-costed)
    collective_counts: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float          # analytic useful flops (global)
    useful_flops_ratio: float   # model_flops / (hlo_flops * n_devices)
    per_device_memory_bytes: Optional[float] = None
    argument_bytes: Optional[float] = None
    meta: Dict = field(default_factory=dict)

    def to_json(self) -> Dict:
        return asdict(self)


def analyze(*, arch: str, shape: str, mesh_name: str, mesh, flops: float, bytes_accessed: float,
            log, dtype: str, model_flops: float, per_device_memory_bytes: Optional[float],
            argument_bytes: Optional[float], meta: Optional[Dict] = None) -> RooflineReport:
    """The report of one cell from its per-device counts and collectives."""
    coll_bytes, coll_counts = collective_wire_bytes(log)
    compute_s = flops / peak_flops(dtype)
    memory_s = bytes_accessed / HBM_BW
    collective_s = collective_seconds(log, mesh)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    denom = flops * mesh.size
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_devices=mesh.size,
        hlo_flops=flops,
        hlo_bytes=bytes_accessed,
        collective_bytes=coll_bytes,
        collective_counts=coll_counts,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / denom) if denom else 0.0,
        per_device_memory_bytes=per_device_memory_bytes,
        argument_bytes=argument_bytes,
        meta=meta or {},
    )
