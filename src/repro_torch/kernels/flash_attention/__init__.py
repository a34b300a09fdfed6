"""Flash attention over GQA heads: ``csrc/flash_attention.cu`` and its plain version."""
