"""Frontier core, as far as the port has come: hardware presets, MoE routing
modules and the execution predictor."""
from repro_torch.core.hardware import (  # noqa: F401
    HARDWARE, A800_SXM4_80G, H100_SXM, TPU_V5E, HardwareSpec, LinkSpec,
    ParallelismConfig,
)
from repro_torch.core.predictor import ExecutionPredictor, StepBreakdown  # noqa: F401
from repro_torch.core.routing import ROUTERS, resolve_router  # noqa: F401
