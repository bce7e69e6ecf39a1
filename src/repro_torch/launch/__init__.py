"""Launchers of the port: ``serve`` (the paper's Table-2 protocol, the
real ``MiniEngine`` against the simulator's prediction)."""
