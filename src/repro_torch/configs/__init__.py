"""Architecture configs of the port (copies of ``repro.configs``' LM and GNN ones)."""
