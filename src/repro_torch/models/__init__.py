"""Models of the port: the decoder LMs (``transformer``, ``layers``)."""
