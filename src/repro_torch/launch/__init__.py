"""Launchers of the port: ``serve`` (the paper's Table-2 protocol, the
real ``MiniEngine`` against the simulator's prediction), ``train`` (AdamW
steps of any config on the synthetic stream, with checkpoints) and
``dryrun`` (every architecture x shape x production mesh costed on fake
tensors by ``hlo_cost``, through ``lowering.lower_step``)."""
