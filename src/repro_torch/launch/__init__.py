"""Launchers of the port: ``serve`` (the paper's Table-2 protocol, the
real ``MiniEngine`` against the simulator's prediction) and ``train`` (AdamW
steps of any config on the synthetic stream, with checkpoints)."""
