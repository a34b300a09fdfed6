"""Launchers and the launch tooling of the port: ``train`` (one device,
``python -m repro_torch.launch.train``); ``mesh`` (abstract meshes and their
``DeviceMesh``), ``cells`` (the dry-run cells), ``sharded`` (one device's
share of an LM cell's step on ``torch.distributed``), ``roofline`` (the
H100's datasheet terms), ``probes`` (affine depth fits) and ``dryrun``
(``python -m repro_torch.launch.dryrun``)."""
