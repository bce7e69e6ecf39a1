"""Command-line surface of the port: :mod:`repro_torch.api.cli` holds
``python -m repro_torch`` (the ``calibrate`` subcommand so far)."""
