"""Flash attention over GQA heads: ``csrc/flash_attention_sm90.cu`` (bf16,
tensor cores), ``csrc/flash_attention.cu`` (fp32, CUDA cores) and their
plain version."""
