"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* :mod:`repro_torch.kernels.spmm_ema` — one fused SpMM+eMA DP stage.
* :mod:`repro_torch.kernels.spmm_blocked` — the SpMM ``A_G @ M``.
* :mod:`repro_torch.kernels.flash_attention` — GQA flash attention (LM path).

Sources live in ``<kernel>/csrc/*.cu`` and are built by
:mod:`repro_torch.kernels._build` at first use on a card.
"""
