"""Models of the port: the decoder LMs (``transformer``, ``layers``) and the
GNNs (``gnn``: GCN, GAT, NequIP, MACE, the neighbour sampler)."""
