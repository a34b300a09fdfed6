"""Models of the port: the decoder LMs (``transformer``, ``layers``), the
GNNs (``gnn``: GCN, GAT, NequIP, MACE, the neighbour sampler) and the
two-tower recommender (``recsys``)."""
