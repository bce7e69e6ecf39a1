"""PD-disaggregated serving system (DistServe/Dynamo style).

Producer (prefill cluster) and consumer (decode cluster) are specialized
pools with independent parallelism; the GlobalController mediates KV-cache
transfers under decode-side memory backpressure.  A thin preset over the
StageGraph topology layer.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import HardwareSpec, ParallelismConfig
from repro_torch.core.opmodels.analytical import OperatorModelSet
from repro_torch.core.policies.batching import BatchingPolicy
from repro_torch.core.topology import (
    ClusterSpec, StageGraph, SystemHandle, build_system,
)


def build_pd(cfg: ModelConfig, hw: HardwareSpec, *,
             n_prefill: int = 1, n_decode: int = 1,
             prefill_par: Optional[ParallelismConfig] = None,
             decode_par: Optional[ParallelismConfig] = None,
             prefill_policy: Optional[BatchingPolicy] = None,
             decode_policy: Optional[BatchingPolicy] = None,
             ops: Optional[OperatorModelSet] = None,
             transfer_bw: Optional[float] = None,
             engine=None,
             routing=None, seed: int = 0,
             memory=None, queue_policy=None,
             memoize: bool = True,
             pipeline=None, transfer_overlap: float = 0.0,
             kv_frac: float = 0.9, fabric=None) -> SystemHandle:
    """PD-disaggregation preset.

    .. deprecated::
        ``build_pd`` is kept as a thin shim over the declarative experiment
        API; prefer ``repro_torch.api.SimSpec`` with
        ``TopologySpec(preset="pd", ...)`` and ``repro_torch.api.run`` — specs
        serialize, validate, and sweep.
    """
    graph = StageGraph(clusters=[
        ClusterSpec("prefill", "prefill", n_replicas=n_prefill,
                    par=prefill_par or ParallelismConfig(tp=1),
                    policy=prefill_policy, seed_offset=0, memoize=memoize),
        ClusterSpec("decode", "decode", n_replicas=n_decode,
                    par=decode_par or ParallelismConfig(tp=1),
                    policy=decode_policy, seed_offset=100, memoize=memoize),
    ], fabric=fabric)
    return build_system(cfg, hw, graph, ops=ops, routing=routing,
                        engine=engine,
                        transfer_bw=transfer_bw, memory=memory,
                        queue_policy=queue_policy, seed=seed,
                        pipeline=pipeline, transfer_overlap=transfer_overlap,
                        kv_frac=kv_frac)
