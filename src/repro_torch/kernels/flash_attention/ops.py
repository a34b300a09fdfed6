"""GQA-aware wrapper of the flash-attention kernel.

Takes model-layout tensors ``q: (b, sq, h, d)`` and ``k, v: (b, sk, h_kv,
d)`` (after RoPE), repeats each kv head over its ``h // h_kv`` query heads,
lays everything out as ``(b·h, s, d)`` and restores the layout afterwards.
On a CUDA tensor the copy into that layout also pads the sequences with
zero rows to a multiple of :data:`BLOCK`, and ``csrc/flash_attention.cu``
runs (it masks the padded keys); each launch adds one to
``flash_attention.launches``.  On a CPU tensor the plain version
(:func:`repro_torch.kernels.flash_attention.ref.flash_attention_ref`)
runs on the unpadded layout.  Any other device, or a shape or dtype the
kernel does not take, raises.

The kernel's tile is fixed at 64 queries by 64 keys, so the reference's
``block_q`` / ``block_k`` (TPU tiling) and ``interpret`` have no
counterpart here.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

from .ref import flash_attention_ref, to_bh

__all__ = ["flash_attention", "BLOCK", "HEAD_DIMS", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: Query rows per CTA and keys per tile; must equal ``kBlock`` in the source.
BLOCK = 64

#: Head dims the kernel is instantiated for (the smoke configs use 16).
HEAD_DIMS = (16, 32, 64, 128)

_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, h_kv, d)
    v: torch.Tensor,  # (b, sk, h_kv, d)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Softmax attention of ``q`` over ``k, v``; returns ``(b, sq, h, d)`` in
    ``q``'s dtype.  Causal masking is top-left aligned (query ``i`` sees
    keys ``j <= i``)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (b, sq, h, d) and k, v (b, sk, h_kv, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, h_kv, dk = k.shape
    if k.shape[0] != b or dk != d or h_kv == 0 or h % h_kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of {_DTYPES} for q, k and v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    sq_pad = -(-sq // BLOCK) * BLOCK
    sk_pad = -(-sk // BLOCK) * BLOCK
    group = h // h_kv
    qb, kb, vb = to_bh(q, 1, sq_pad), to_bh(k, group, sk_pad), to_bh(v, group, sk_pad)
    out = torch.empty_like(qb)
    status = _library().flash_attention_launch(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
        b * h, sq_pad, sk_pad, sk, d, int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out.view(b, h, sq_pad, d)[:, :, :sq].transpose(1, 2)


flash_attention.launches = 0
