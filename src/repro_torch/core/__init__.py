"""Frontier core: stage-centric, event-driven LLM inference simulation
(the port; the JAX package is its reference)."""
from repro_torch.core.engine import SimEngine  # noqa: F401
from repro_torch.core.events import EV, Event  # noqa: F401
from repro_torch.core.request import Request, RState  # noqa: F401
from repro_torch.core.hardware import (  # noqa: F401
    HARDWARE, A800_SXM4_80G, H100_SXM, TPU_V5E, HardwareSpec, LinkSpec,
    ParallelismConfig,
)
from repro_torch.core.predictor import ExecutionPredictor, StepBreakdown  # noqa: F401
from repro_torch.core.controller import GlobalController  # noqa: F401
from repro_torch.core.cluster import ClusterWorker, ReplicaWorker, Hooks  # noqa: F401
from repro_torch.core.metrics import MetricsCollector, pareto_frontier  # noqa: F401
from repro_torch.core.topology import (  # noqa: F401
    ClusterSpec, StageGraph, SystemHandle, build_system,
)
from repro_torch.core.routing import ROUTERS, resolve_router  # noqa: F401
from repro_torch.core.policies.memory import (  # noqa: F401
    MEMORY, KVCacheManager, KVTransferPlan, MonolithicKVManager,
    PagedKVManager, PrefixCachingKVManager, resolve_memory,
)
from repro_torch.core.pipeline import (  # noqa: F401
    PIPELINES, PipelineConfig, resolve_pipeline,
)
from repro_torch.core.workflows.colocated import build_colocated  # noqa: F401
from repro_torch.core.workflows.pd_disagg import build_pd  # noqa: F401
from repro_torch.core.workflows.af_disagg import (  # noqa: F401
    AFStepStats, build_af, simulate_af_decode_step, AFPipelinePredictor,
)
