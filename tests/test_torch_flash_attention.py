"""The port's ``flash_attention`` against the reference's, on the CPU.

On CPU tensors the port's wrapper runs its plain version (``ref.py``); the
reference runs its Pallas kernel in interpret mode.  Both get the same
numpy inputs.  The kernels themselves are checked against the plain
version on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
6); here an emulation of the bf16 kernel's arithmetic keeps its numeric
design (P split into two bf16 parts) checked against the card's gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, to_bh


def _mk(b, sq, sk, h, h_kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h_kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, h_kv, d)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    out = flash_attention(*(torch.as_tensor(x).to(dtype) for x in (q, k, v)), causal=causal)
    return out.float().numpy()


def _ref(q, k, v, causal, block_q, block_k, dtype=jnp.float32):
    out = ref_flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal,
                              block_q=block_q, block_k=block_k, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,sq,sk,h,h_kv,d,bq,bk",
    [
        (2, 128, 128, 4, 4, 64, 64, 64),      # MHA square
        (1, 256, 256, 4, 2, 64, 128, 64),     # GQA
        (2, 128, 256, 8, 1, 32, 64, 128),     # MQA, rectangular (kv longer)
        (1, 192, 192, 2, 2, 64, 64, 64),      # non-power-of-two seq (pads)
    ],
)
def test_matches_reference_kernel(causal, b, sq, sk, h, h_kv, d, bq, bk):
    """Key lengths here are multiples of the reference's block, where its
    padding adds no keys, so it is exact in both modes."""
    q, k, v = _mk(b, sq, sk, h, h_kv, d)
    np.testing.assert_allclose(_port(q, k, v, causal), _ref(q, k, v, causal, bq, bk),
                               rtol=2e-5, atol=2e-5)


def test_causal_ragged_matches_reference_kernel():
    q, k, v = _mk(1, 200, 200, 4, 2, 32, seed=5)
    np.testing.assert_allclose(_port(q, k, v, True), _ref(q, k, v, True, 64, 64),
                               rtol=2e-5, atol=2e-5)


def test_bf16_matches_reference_kernel():
    q, k, v = _mk(1, 128, 128, 2, 2, 64, seed=2)
    port = _port(q, k, v, True, torch.bfloat16)
    ref = _ref(q, k, v, True, 64, 64, jnp.bfloat16)
    exact = _port(q, k, v, True)
    assert np.abs(port - ref).max() < 2e-2
    assert np.abs(port - exact).max() < 2e-2  # bf16 tolerance


def test_noncausal_ragged_matches_exact_attention():
    """Non-causal attention over a key length that is no multiple of the
    block is held against ``attention_ref``, not the reference kernel: the
    reference pads K/V with zero rows and masks only causally, so its
    non-causal softmax gives the padded keys weight exp(0 - m) (ROADMAP
    queue 3).  The port masks keys past the true length."""
    b, s, h, h_kv, d = 1, 100, 2, 1, 64
    q, k, v = _mk(b, s, s, h, h_kv, d, seed=7)
    kk, vv = np.repeat(k, h // h_kv, axis=2), np.repeat(v, h // h_kv, axis=2)

    def to_bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))

    want = np.asarray(ref_attention_ref(to_bh(q), to_bh(kk), to_bh(vv), causal=False))
    want = want.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_port(q, k, v, False), want, rtol=2e-5, atol=2e-5)


def test_plain_version_chunks_queries_exactly():
    """``attention_ref``'s query chunks (and the causal key trim) give the
    unchunked result."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.standard_normal((3, 70, 16)).astype(np.float32)) for _ in range(3))
    for causal in (True, False):
        torch.testing.assert_close(attention_ref(q, k, v, causal, q_chunk=16),
                                   attention_ref(q, k, v, causal, q_chunk=128),
                                   rtol=1e-6, atol=1e-6)


def test_wrapper_checks_and_counts_no_cpu_launch():
    q = torch.zeros((1, 8, 2, 64))
    before = flash_attention.launches, flash_attention.tensor_core_launches
    flash_attention(q, q[:, :, :1], q[:, :, :1])
    flash_attention(q.bfloat16(), q[:, :, :1].bfloat16(), q[:, :, :1].bfloat16())
    # the CPU runs the plain version
    assert (flash_attention.launches, flash_attention.tensor_core_launches) == before
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros((1, 8, 2, 48)), torch.zeros((1, 8, 2, 48)),
                        torch.zeros((1, 8, 2, 48)))
    assert 48 not in HEAD_DIMS
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, torch.zeros((1, 8, 3, 64)), torch.zeros((1, 8, 3, 64)))
    meta = q.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(meta, meta, meta)


# ---------------------------------------------------------------------------
# The bf16 kernel's arithmetic (csrc/flash_attention_sm90.cu), emulated
# ---------------------------------------------------------------------------

#: The card's gate for the bf16 kernel against its plain version
#: (``chip_smoke.py`` FLASH_RTOL / FLASH_ATOL, ``tests/test_torch_cuda.py``).
CARD_RTOL, CARD_ATOL = 1e-2, 1e-4


def _emulate_bf16_kernel(q, k, v, split_p, block_k=64):
    """Causal attention as the tensor-core kernel computes it: fp32 scores
    of bf16 inputs, an online softmax over ``block_k``-key tiles in the log2
    domain, P rounded to bf16 for the P.V product (``split_p``: as p_hi +
    p_lo, two products), fp32 O divided by the row sum at the end, bf16
    out.  ``q, k, v``: (bh, s, d) bf16 (kv heads already repeated)."""
    bh, s, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = 1.4426950408889634 / np.sqrt(d)
    m = torch.full((bh, s, 1), -1e30)
    l = torch.zeros((bh, s, 1))
    o = torch.zeros((bh, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, block_k):
        cols = torch.arange(k0, min(s, k0 + block_k))[None, :]
        x = (qf @ kf[:, k0: k0 + block_k].transpose(1, 2)) * scale_log2
        x = x.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.where(x > -5e29, torch.exp2(x - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        o = o * alpha + hi @ vf[:, k0: k0 + block_k]
        if split_p:
            o = o + (p - hi).bfloat16().float() @ vf[:, k0: k0 + block_k]
        m = m_new
    return (o / l).bfloat16()


def _card_gate_breaks(got, want):
    got, want = got.float(), want.float()
    return int(((got - want).abs() > CARD_ATOL + CARD_RTOL * want.abs()).sum())


def _bf16_heads(s, seed):
    b, h, h_kv, d = 1, 4, 2, 128
    q, k, v = (torch.as_tensor(x).bfloat16() for x in _mk(b, s, s, h, h_kv, d, seed=seed))
    return to_bh(q, 1), to_bh(k, h // h_kv), to_bh(v, h // h_kv)


@pytest.mark.parametrize("s", [256, 1000])
def test_split_p_meets_the_card_gate(s):
    """P = p_hi + p_lo in two bf16 products keeps the kernel within the
    card's gate against the plain version (fp32 softmax, bf16 out)."""
    q, k, v = _bf16_heads(s, seed=11)
    want = attention_ref(q, k, v, causal=True)
    assert _card_gate_breaks(_emulate_bf16_kernel(q, k, v, split_p=True), want) == 0


@pytest.mark.parametrize("s", [256, 1000])
def test_single_bf16_p_breaks_the_card_gate(s):
    """One bf16 P does not: near-zero outputs keep its rounding error.  This
    is why the kernel runs the second P.V product."""
    q, k, v = _bf16_heads(s, seed=11)
    want = attention_ref(q, k, v, causal=True)
    assert _card_gate_breaks(_emulate_bf16_kernel(q, k, v, split_p=False), want) > 0


def test_split_p_and_cpu_path_meet_the_card_gate_against_reference_kernel():
    """At a ragged s (no multiple of any tile), the emulated bf16 kernel and
    the port's CPU path both stay within the card's gate against the
    reference's Pallas kernel (interpret mode, fp32 softmax, bf16 out)."""
    b, s, h, h_kv, d = 1, 1000, 4, 2, 128
    q, k, v = _mk(b, s, s, h, h_kv, d, seed=11)
    want = torch.from_numpy(_ref(q, k, v, True, 128, 128, jnp.bfloat16).copy())
    qb, kb, vb = (torch.as_tensor(x).bfloat16() for x in (q, k, v))
    emulated = _emulate_bf16_kernel(to_bh(qb, 1), to_bh(kb, h // h_kv), to_bh(vb, h // h_kv),
                                    split_p=True)
    assert _card_gate_breaks(emulated.view(b, h, s, d).transpose(1, 2), want) == 0
    assert _card_gate_breaks(torch.as_tensor(_port(q, k, v, True, torch.bfloat16)), want) == 0
