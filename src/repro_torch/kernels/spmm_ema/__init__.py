"""Fused SpMM+eMA: one tree DP stage per launch."""
