"""Training substrate of the port: optimizers (``optimizer``), checkpoints
(``checkpoint``), the fault-tolerant loop (``loop``), gradient compression
(``compression``) and elastic planning and resharding (``elastic``); trees in
``jax.tree``'s leaf order (``tree``)."""
