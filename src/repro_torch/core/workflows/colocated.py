"""Colocated serving system (the traditional deployment baseline).

A thin preset over the StageGraph topology layer: one cluster, role
"colocated".  SystemHandle/_kv_budget live in repro_torch.core.topology and are
re-exported here for backward compatibility.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import SimEngine
from repro_torch.core.hardware import HardwareSpec, ParallelismConfig
from repro_torch.core.opmodels.analytical import OperatorModelSet
from repro_torch.core.policies.batching import BatchingPolicy
from repro_torch.core.topology import (  # noqa: F401  (re-exports)
    ClusterSpec, StageGraph, SystemHandle, _kv_budget, build_system,
)


def build_colocated(cfg: ModelConfig, hw: HardwareSpec, *,
                    n_replicas: int = 1,
                    par: Optional[ParallelismConfig] = None,
                    policy: Optional[BatchingPolicy] = None,
                    ops: Optional[OperatorModelSet] = None,
                    engine: Optional[SimEngine] = None,
                    routing=None, seed: int = 0,
                    memory=None, queue_policy=None,
                    memoize: bool = True,
                    pipeline=None, transfer_overlap: float = 0.0,
                    kv_frac: float = 0.9, fabric=None) -> SystemHandle:
    """Colocated preset.

    .. deprecated::
        ``build_colocated`` is kept as a thin shim over the declarative
        experiment API; prefer ``repro_torch.api.SimSpec`` with
        ``TopologySpec(preset="colocated", ...)`` and ``repro_torch.api.run`` —
        specs serialize, validate, and sweep.
    """
    graph = StageGraph(clusters=[
        ClusterSpec("colocated", "colocated", n_replicas=n_replicas,
                    par=par or ParallelismConfig(tp=1), policy=policy,
                    replica_prefix="colo", memoize=memoize),
    ], fabric=fabric)
    return build_system(cfg, hw, graph, ops=ops, routing=routing,
                        engine=engine, memory=memory,
                        queue_policy=queue_policy, seed=seed,
                        pipeline=pipeline, transfer_overlap=transfer_overlap,
                        kv_frac=kv_frac)
