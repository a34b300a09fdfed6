"""Blocked SpMM ``A_G @ M`` over the compact edge operand."""
