"""Launchers of the port: ``python -m repro_torch.launch.train`` (one
device).  The reference's dry-run tooling (``cells``, ``dryrun``,
``probes``, ``roofline``, ``mesh``) is ROADMAP queue 1 item 14b."""
