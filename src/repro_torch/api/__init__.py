"""Declarative experiment API: SimSpec -> run -> Report, and sweeps.

This package is the public surface of the simulator:

- :mod:`repro_torch.api.spec` — ``SimSpec`` and its serializable sub-specs
  (model / topology / workload / policy / opmodel / SLO / faults);
- :mod:`repro_torch.api.run` — ``run(spec) -> Report`` (typed, self-describing);
- :mod:`repro_torch.api.sweep` — grid/zip expansion with process-pool fan-out,
  JSONL streaming, and ``pareto`` / ``best_under_slo`` helpers;
- :mod:`repro_torch.api.cli` — the ``python -m repro_torch`` command line.
"""
from repro_torch.api.run import Report, build, run  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    AutoscalerSpec, FaultSpec, FleetSpec, InstanceSpec, MemorySpec,
    ModelRef, ObsSpec, OpModelSpec, PipelineSpec, PolicySpec, SimSpec,
    SLOSpec, SpecError, TenantSpec, TopologySpec, WorkloadSpec,
)
from repro_torch.api.sweep import best_under_slo, expand, pareto, sweep  # noqa: F401

__all__ = [
    "SimSpec", "ModelRef", "TopologySpec", "WorkloadSpec", "PolicySpec",
    "OpModelSpec", "PipelineSpec", "MemorySpec", "SLOSpec", "FaultSpec",
    "FleetSpec", "InstanceSpec", "TenantSpec", "AutoscalerSpec",
    "ObsSpec", "SpecError",
    "run", "build", "Report",
    "sweep", "expand", "pareto", "best_under_slo",
]
