"""Models of the port: the dense-GQA decoder LM (``transformer``, ``layers``)."""
