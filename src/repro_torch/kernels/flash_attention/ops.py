"""GQA-aware wrapper of the flash-attention kernels.

Takes model-layout tensors ``q: (b, sq, h, d)`` and ``k, v: (b, sk, h_kv,
d)`` (after RoPE) and returns ``out: (b, sq, h, d)``, contiguous.  On CUDA
tensors the kernels read q, k and v where they lie, through their batch,
row and head strides (query head ``hq`` reads kv head ``hq // (h //
h_kv)``), and write ``out`` directly: the wrapper makes no copy.

- bf16: ``csrc/flash_attention_sm90.cu``, both products on the tensor cores
  (wgmma, TMA loads); adds one to ``flash_attention.tensor_core_launches``.
- fp32: ``csrc/flash_attention.cu``, both products on the fp32 CUDA cores
  (the fp32 forward's logits gate rules out rounding the inputs).

Either launch adds one to ``flash_attention.launches``.  On a CPU tensor
the plain version
(:func:`repro_torch.kernels.flash_attention.ref.flash_attention_ref`)
runs.  Any other device, or a shape, dtype or layout the kernels do not
take, raises.

Both paths run inside one ``torch.autograd.Function`` whose backward
raises ``NotImplementedError``: the reference's Pallas kernel has no
gradient either (``jax.grad`` through it fails), and training uses
``attn_impl="sdpa"``.  A forward with inputs that require grad works; a
backward through it fails on the card and on the CPU alike, instead of
leaving ``w_q``, ``w_k``, ``w_v`` and the residual path through attention
without gradient.

The kernels' tiles are fixed (bf16: 128 queries by 128 keys; fp32: 64 by
64), so the reference's ``block_q`` / ``block_k`` (TPU tiling) and
``interpret`` have no counterpart here.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

from .ref import flash_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"

#: The kernel of each input dtype and its C entry point.
SOURCES = {
    torch.bfloat16: (_CSRC / "flash_attention_sm90.cu", "flash_attention_sm90_launch"),
    torch.float32: (_CSRC / "flash_attention.cu", "flash_attention_launch"),
}

#: Head dims the kernels are instantiated for (the smoke configs use 16).
HEAD_DIMS = (16, 32, 64, 128)


def _entry(dtype: torch.dtype):
    source, name = SOURCES[dtype]
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int64), p]
        fn.restype = ctypes.c_int
    return fn


def _strides(x: torch.Tensor, align: int) -> list:
    """Element strides (batch, row, head) of a ``(b, s, n, d)`` tensor.  A
    dimension of extent 1 is never stepped, so its stride is replaced by
    the dense one (the tensor maps still need it aligned).  Raises unless
    ``d`` has unit stride and the others, and the pointer, are aligned to
    ``align`` elements (16 bytes: float4 loads and TMA)."""
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention needs unit stride on the head dim; got {x.stride()}")
    out = []
    for i in range(3):
        dense = x.shape[i + 1 :].numel()
        out.append(x.stride(i) if x.shape[i] > 1 else dense)
    if any(s % align for s in out) or x.data_ptr() % 16:
        raise ValueError(f"flash_attention needs 16-byte aligned rows and heads; got strides "
                         f"{x.stride()} at address {x.data_ptr():#x}")
    return out


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
    if q.dtype not in SOURCES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of {tuple(SOURCES)} for q, k and v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _FlashAttention.apply(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    """The forward of either path; no backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention has no backward: the reference's Pallas kernel has no "
            "gradient either; train with attn_impl='sdpa'")


def _launch(q, k, v, causal) -> torch.Tensor:
    """One launch of the kernel of ``q``'s dtype on validated CUDA inputs."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out  # nothing to launch
    align = 16 // q.element_size()
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in _strides(x, align)))
    status = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, h_kv, d, int(causal), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.tensor_core_launches += 1
    return out


flash_attention.launches = 0
flash_attention.tensor_core_launches = 0
