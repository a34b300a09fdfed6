"""Deterministic synthetic data of the port (``pipeline.token_batches``)."""
