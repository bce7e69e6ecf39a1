"""Fleet control plane: multi-instance serving, global routing, autoscaling.

The layer above a single deployment: N serving *instances* (each a full
``GlobalController`` deployment — colocated, PD- or AF-disaggregated,
heterogeneous mixes allowed) share one deterministic ``SimEngine`` behind
a pluggable global router, optionally scaled by an SLO-driven autoscaler.

Declaratively, a fleet is the ``fleet:`` section of a SimSpec::

    fleet:
      instances:
        - {name: big, count: 2, topology: {preset: pd, n_decode: 2}}
        - {name: small, count: 2}            # inherits spec.topology
      router: prefix_affinity
      autoscaler: {max_instances: 8, up_queue_depth: 12}
      tenants:
        - {name: paid, weight: 1, ttft_s: 0.5, priority: 0}
        - {name: free, weight: 3, ttft_s: 2.0, priority: 1}

and ``repro_torch.api.run(spec)`` returns a :class:`FleetReport`.

- :mod:`repro_torch.fleet.router` — ``FleetRouter`` protocol + ``FLEET_ROUTERS``
  registry (round_robin | least_outstanding | power_of_two |
  prefix_affinity);
- :mod:`repro_torch.fleet.instance` — instance lifecycle (cold start, drain)
  and GPU-second accounting;
- :mod:`repro_torch.fleet.autoscaler` — queue-depth / SLO-attainment scaling and
  P:D pool rebalancing;
- :mod:`repro_torch.fleet.controller` — the fleet control plane itself;
- :mod:`repro_torch.fleet.report` — ``run_fleet(spec) -> FleetReport``.
"""
from repro_torch.fleet.autoscaler import Autoscaler  # noqa: F401
from repro_torch.fleet.controller import FleetController  # noqa: F401
from repro_torch.fleet.instance import Instance  # noqa: F401
from repro_torch.fleet.report import FleetReport, run_fleet  # noqa: F401
from repro_torch.fleet.router import (  # noqa: F401
    FLEET_ROUTERS, FleetRouter, resolve_fleet_router,
)

__all__ = [
    "FLEET_ROUTERS", "FleetRouter", "resolve_fleet_router",
    "Instance", "Autoscaler", "FleetController",
    "FleetReport", "run_fleet",
]
