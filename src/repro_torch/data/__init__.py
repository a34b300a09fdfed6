"""Deterministic synthetic data of the port (``pipeline``: the token stream,
the GNN graphs)."""
