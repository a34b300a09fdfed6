"""E(3)-equivariant building blocks in Cartesian form (l <= 2).

Irreps are Cartesian tensors, equivalent to real spherical-harmonic irreps
for l <= 2, so every operation is an einsum:

* l=0 scalars:  ``(n, c0)``
* l=1 vectors:  ``(n, c1, 3)``         — transform as ``R v``
* l=2 tensors:  ``(n, c2, 3, 3)``      — symmetric traceless, ``R T R^T``

The Clebsch-Gordan paths of NequIP/MACE become dot, cross and outer
products; equivariance is checked numerically in the tests by rotating
the inputs.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "Irreps",
    "spherical_l1",
    "spherical_l2",
    "bessel_basis",
    "cutoff_envelope",
    "tp_paths_order2",
    "linear_mix",
    "init_linear_mix",
    "gate",
]


class Irreps(NamedTuple):
    """A bundle of l=0,1,2 feature channels."""

    s: torch.Tensor  # (n, c0)
    v: torch.Tensor  # (n, c1, 3)
    t: torch.Tensor  # (n, c2, 3, 3) symmetric traceless

    def rotate(self, r: torch.Tensor) -> "Irreps":
        """Apply a global rotation (test utility)."""
        return Irreps(
            s=self.s,
            v=torch.einsum("ij,ncj->nci", r, self.v),
            t=torch.einsum("ij,ncjk,lk->ncil", r, self.t, r),
        )


def spherical_l1(unit: torch.Tensor) -> torch.Tensor:
    """Y1 = r_hat; (e, 3)."""
    return unit


def spherical_l2(unit: torch.Tensor) -> torch.Tensor:
    """Y2 = r_hat r_hat^T - I/3 (symmetric traceless); (e, 3, 3)."""
    eye = torch.eye(3, dtype=unit.dtype, device=unit.device)
    return unit[:, :, None] * unit[:, None, :] - eye / 3.0


def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """NequIP radial basis: sin(n pi r / r_c) / r, n = 1..n_rbf; (e, n_rbf)."""
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rs = r.clamp(min=1e-9)[:, None]
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rs / cutoff) / rs


def cutoff_envelope(r: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """Polynomial cutoff (smooth to p-th order) — zero outside the cutoff."""
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    out = (
        1.0
        - ((p + 1.0) * (p + 2.0) / 2.0) * x**p
        + p * (p + 2.0) * x ** (p + 1)
        - (p * (p + 1.0) / 2.0) * x ** (p + 2)
    )
    return torch.where(r < cutoff, out, torch.zeros((), dtype=out.dtype, device=out.device))


# ---------------------------------------------------------------------------
# Tensor-product contraction paths (order 2): all CG-allowed combinations of
# two irreps (a from set A, b from set B) into l=0/1/2 outputs.
# ---------------------------------------------------------------------------


def _sym_traceless(m: torch.Tensor) -> torch.Tensor:
    sym = 0.5 * (m + m.transpose(-1, -2))
    tr = sym.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return sym - tr * torch.eye(3, dtype=m.dtype, device=m.device) / 3.0


def tp_paths_order2(a: Irreps, b: Irreps) -> Irreps:
    """Channel-aligned tensor product a (x) b -> irreps.

    Channels are contracted elementwise (equal channel counts: the "uvu"
    mode of e3nn); outputs concatenate every allowed path per l.
    """
    s_parts = [
        a.s * b.s,                                           # 0x0 -> 0
        torch.einsum("nci,nci->nc", a.v, b.v),               # 1x1 -> 0
        torch.einsum("ncij,ncij->nc", a.t, b.t),             # 2x2 -> 0
    ]
    v_parts = [
        a.s[..., None] * b.v,                                # 0x1 -> 1
        b.s[..., None] * a.v,                                # 1x0 -> 1
        torch.linalg.cross(a.v, b.v, dim=-1),                # 1x1 -> 1
        torch.einsum("ncij,ncj->nci", a.t, b.v),             # 2x1 -> 1
        torch.einsum("ncij,ncj->nci", b.t, a.v),             # 1x2 -> 1
    ]
    t_parts = [
        a.s[..., None, None] * b.t,                          # 0x2 -> 2
        b.s[..., None, None] * a.t,                          # 2x0 -> 2
        _sym_traceless(a.v[..., :, None] * b.v[..., None, :]),         # 1x1 -> 2
        _sym_traceless(torch.einsum("ncik,nckj->ncij", a.t, b.t)),     # 2x2 -> 2
    ]
    return Irreps(
        s=torch.cat(s_parts, dim=-1),
        v=torch.cat(v_parts, dim=-2),
        t=torch.cat(t_parts, dim=-3),
    )


def linear_mix(params: Dict[str, torch.Tensor], x: Irreps) -> Irreps:
    """Per-l channel mixing (the equivariant 'self-interaction' linear)."""
    return Irreps(
        s=torch.einsum("nc,cd->nd", x.s, params["w_s"]),
        v=torch.einsum("nci,cd->ndi", x.v, params["w_v"]),
        t=torch.einsum("ncij,cd->ndij", x.t, params["w_t"]),
    )


def _normal(gen: Optional[torch.Generator], shape, device: torch.device) -> torch.Tensor:
    """Standard normal draws; on the ``meta`` device, shapes only."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=device)


def init_linear_mix(gen: Optional[torch.Generator], c_in: Tuple[int, int, int],
                    c_out: Tuple[int, int, int], device: torch.device) -> Dict:
    def w(ci, co):
        return _normal(gen, (ci, co), device) / math.sqrt(max(ci, 1))

    return {"w_s": w(c_in[0], c_out[0]), "w_v": w(c_in[1], c_out[1]), "w_t": w(c_in[2], c_out[2])}


def gate(x: Irreps) -> Irreps:
    """Equivariant gate (NequIP): the trailing ``c1 + c2`` scalar channels are
    consumed as sigmoid gates for the vector / tensor channels; the leading
    channels pass through silu.  The pre-gate linear must therefore emit
    ``feat + c1 + c2`` scalars."""
    c1, c2 = x.v.shape[1], x.t.shape[1]
    feat = x.s.shape[1] - c1 - c2
    if feat <= 0:
        raise ValueError(f"gate needs {c1 + c2} gate scalars on top of features; got s width {x.s.shape[1]}")
    gates_v = torch.sigmoid(x.s[:, feat : feat + c1])
    gates_t = torch.sigmoid(x.s[:, feat + c1 :])
    return Irreps(
        s=F.silu(x.s[:, :feat]),
        v=x.v * gates_v[..., None],
        t=x.t * gates_t[..., None, None],
    )
