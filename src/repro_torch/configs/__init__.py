"""Architecture configs of the port (copies of ``repro.configs``' LM, GNN and recsys ones)."""
