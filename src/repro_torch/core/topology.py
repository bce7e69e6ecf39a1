"""Declarative StageGraph topology layer.

A serving system is described as a *StageGraph*: a set of ClusterSpecs
(role, replica count, per-cluster hardware and parallelism, step model) plus
directed LinkSpecs between clusters (asymmetric bandwidths, base latency).
``build_system`` compiles the graph into the event-driven runtime objects
(GlobalController, ClusterWorkers, ReplicaWorkers) — the single place where
replicas are constructed.  ``build_colocated`` / ``build_pd`` / ``build_af``
are thin presets over this layer, and new combinations — PD front + AF
decode with heterogeneous hardware per cluster, multiple decode pools,
cross-cluster expert placement — are one-liner graph edits.

Example (heterogeneous PD + AF decode with cross-cluster EP)::

    graph = StageGraph(
        clusters=[
            ClusterSpec("prefill", "prefill", n_replicas=2,
                        par=ParallelismConfig(tp=2)),
            ClusterSpec("decode", "decode", step="af", m=2,
                        hardware=H100_SXM,
                        attn_par=ParallelismConfig(tp=2),
                        ffn_par=ParallelismConfig(ep=8),
                        remote_expert_ranks=(6, 7),
                        expert_cluster_hw=A800_SXM4_80G),
        ],
        links=[LinkSpec("prefill", "decode", bandwidth=50e9),
               LinkSpec("decode", "prefill", bandwidth=25e9)])
    handle = build_system(cfg, A800_SXM4_80G, graph)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import ClusterWorker, ReplicaWorker
from repro_torch.core.controller import GlobalController
from repro_torch.core.engine import SimEngine
from repro_torch.core.fabric import Fabric, FabricConfig, FabricOps
from repro_torch.core.hardware import HardwareSpec, LinkSpec, ParallelismConfig
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.opmodels.analytical import OperatorModelSet
from repro_torch.core.pipeline import PipelineConfig, resolve_pipeline
from repro_torch.core.policies.batching import (
    BatchingPolicy, ChunkedPrefill, ContinuousBatching,
)
from repro_torch.core.predictor import ExecutionPredictor
from repro_torch.core.request import Request
from repro_torch.core.routing import resolve_router

ROLES = ("prefill", "decode", "colocated")


@dataclass
class SystemHandle:
    engine: SimEngine
    controller: GlobalController
    clusters: dict
    n_devices: int
    fabric: Optional[Fabric] = None

    def run(self, requests: List[Request], until: float = float("inf"), *,
            closed_concurrency: Optional[int] = None,
            slo_ttft: Optional[float] = None,
            slo_tpot: Optional[float] = None):
        """Replay ``requests`` through the event engine and report metrics.

        ``closed_concurrency`` switches to closed-loop injection: at most
        that many requests in flight, the next one arriving when a slot
        frees.  The metrics window starts at the first actual arrival.
        """
        if closed_concurrency is not None:
            self.controller.submit_closed(requests, closed_concurrency)
        else:
            self.controller.submit_all(requests)
        self.engine.run(until)
        rep = self.controller.metrics.report(
            n_devices=self.n_devices, slo_ttft=slo_ttft, slo_tpot=slo_tpot)
        rep["preemptions"] = sum(w.stats.get("preemptions", 0)
                                 for c in self.clusters.values()
                                 for w in c.replicas)
        return rep


def _kv_budget(cfg: ModelConfig, hw: HardwareSpec, par: ParallelismConfig,
               pred: ExecutionPredictor, frac: float = 0.9) -> float:
    """KV memory per replica = devices*(HBM - weights) * frac.

    ``frac`` is the cache-size knob (``MemorySpec.capacity_frac``): the
    fraction of post-weight HBM given to the KV cache — sweeping it down
    simulates memory pressure without changing the hardware.
    """
    total = hw.hbm_capacity * par.devices
    weights = 2.0 * cfg.param_count()
    # the floor scales with frac too (frac=0.9 keeps the legacy 5% floor),
    # so capacity_frac sweeps stay monotone even when weights dominate
    return max((total - weights) * frac, hw.hbm_capacity * frac / 18.0)


@dataclass
class ClusterSpec:
    """One specialized hardware pool in the topology."""
    name: str
    role: str                                  # "prefill"|"decode"|"colocated"
    n_replicas: int = 1
    par: ParallelismConfig = field(default_factory=ParallelismConfig)
    hardware: Optional[HardwareSpec] = None    # None -> topology default hw
    policy: Optional[BatchingPolicy] = None    # None -> role default
    step: str = "dense"                        # "dense" | "af" (event graph)
    # AF step parameters (step == "af")
    m: int = 2
    attn_par: Optional[ParallelismConfig] = None
    ffn_par: Optional[ParallelismConfig] = None
    # cross-cluster expert placement: these EP ranks live on a remote expert
    # cluster (its hardware / link given below), reached per dispatch/combine
    remote_expert_ranks: Tuple[int, ...] = ()
    expert_cluster_hw: Optional[HardwareSpec] = None
    expert_link: Optional[LinkSpec] = None
    seed_offset: int = 0
    replica_prefix: Optional[str] = None       # default: cluster name
    # step-time memo cache (see ExecutionPredictor); False -> exact
    # per-step operator-graph walks and routing draws
    memoize: bool = True
    # latency-hiding strategy (repro_torch.core.pipeline.PipelineConfig); None
    # falls back to build_system's topology-wide default (also None ->
    # the legacy serial-per-micro-batch model, bit-for-bit)
    pipeline: Optional["PipelineConfig"] = None

    def devices_per_replica(self) -> int:
        if self.step == "af":
            ap = self.attn_par or self.par
            fp = self.ffn_par or self.par
            return ap.devices + fp.devices
        return self.par.devices


@dataclass
class StageGraph:
    """The full topology: clusters + directed inter-cluster links."""
    clusters: List[ClusterSpec]
    links: List[LinkSpec] = field(default_factory=list)
    # shared-fabric contention model; None or mode="none" keeps the legacy
    # isolated point-to-point pricing bit-identically
    fabric: Optional[FabricConfig] = None

    def validate(self) -> None:
        names = [c.name for c in self.clusters]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cluster names: {names}")
        for c in self.clusters:
            if c.role not in ROLES:
                raise ValueError(f"cluster {c.name}: unknown role {c.role!r}")
            if c.step not in ("dense", "af"):
                raise ValueError(f"cluster {c.name}: unknown step {c.step!r}")
            if c.remote_expert_ranks:
                fp = c.ffn_par or c.par
                ep = max(fp.ep, fp.tp, 1)
                bad = [r for r in c.remote_expert_ranks if not 0 <= r < ep]
                if bad:
                    raise ValueError(f"cluster {c.name}: remote_expert_ranks "
                                     f"{bad} out of range for ep={ep}")
            elif c.expert_cluster_hw is not None or c.expert_link is not None:
                raise ValueError(
                    f"cluster {c.name}: expert_cluster_hw/expert_link have "
                    f"no effect without remote_expert_ranks")
        for l in self.links:
            for end in (l.src, l.dst):
                if end not in names:
                    raise ValueError(f"link {l.src}->{l.dst}: unknown "
                                     f"cluster {end!r}")
        roles = {c.role for c in self.clusters}
        if "colocated" in roles and roles != {"colocated"}:
            raise ValueError(
                "colocated clusters cannot be mixed with prefill/decode "
                f"roles (got {sorted(roles)})")
        if roles != {"colocated"} and roles != {"prefill", "decode"}:
            raise ValueError(
                f"a topology is either all-colocated or prefill+decode; "
                f"got roles {sorted(roles)}")

    @property
    def mode(self) -> str:
        roles = {c.role for c in self.clusters}
        return "pd" if "prefill" in roles and "decode" in roles else "colocated"

    @property
    def entry_clusters(self) -> List[str]:
        want = "prefill" if self.mode == "pd" else "colocated"
        return [c.name for c in self.clusters if c.role == want]

    def link_table(self) -> Dict[Tuple[str, str], LinkSpec]:
        return {(l.src, l.dst): l for l in self.links}


def _default_policy(role: str) -> BatchingPolicy:
    if role == "prefill":
        return ContinuousBatching(max_batched_tokens=16384)
    if role == "decode":
        return ContinuousBatching(max_num_seqs=512)
    return ContinuousBatching()


def build_system(cfg: ModelConfig, hw: HardwareSpec, graph: StageGraph, *,
                 ops: Optional[OperatorModelSet] = None,
                 routing: Union[None, str, dict, "RoutingModule"] = None,
                 engine: Optional[SimEngine] = None,
                 transfer_bw: Optional[float] = None,
                 memory: Union[None, str, dict] = None,
                 queue_policy: Union[None, str, dict, "QueuePolicy"] = None,
                 seed: int = 0,
                 pipeline: Union[None, str, dict, PipelineConfig] = None,
                 transfer_overlap: float = 0.0,
                 kv_frac: float = 0.9,
                 ) -> SystemHandle:
    """Compile a StageGraph into a runnable SystemHandle.

    ``hw``/``ops`` are the topology defaults; a ClusterSpec with its own
    ``hardware`` gets a fresh analytical OperatorModelSet for it (pass a
    custom ``ops`` only for homogeneous-hardware clusters).  ``memory``
    ("paged"/"prefix"/"monolithic" + kwargs incl. preemption/swap_bw) and
    ``queue_policy`` ("fcfs"/"sjf"/"priority") select registered KV-manager
    and queue-ordering policies for every replica.  ``pipeline`` (name /
    mapping / PipelineConfig) selects the latency-hiding strategy for every
    cluster that does not carry its own ``ClusterSpec.pipeline``; None
    keeps the legacy serial model bit-for-bit.  ``transfer_overlap`` in
    (0, 1] switches PD KV handoffs to layer-wise streamed transfer
    (0 keeps the legacy lump-sum pricing bit-for-bit); ``kv_frac`` sets
    the fraction of post-weight HBM given to the KV cache.
    """
    from repro_torch.core.policies.memory import resolve_memory
    from repro_torch.core.policies.scheduling import resolve_scheduler
    from repro_torch.core.workflows.af_disagg import AFPipelinePredictor
    graph.validate()
    for spec in graph.clusters:
        if spec.remote_expert_ranks and cfg.moe is None:
            raise ValueError(
                f"cluster {spec.name}: remote_expert_ranks requires an MoE "
                f"model config ({cfg.name} is dense)")
    engine = engine or SimEngine()
    ops = ops or OperatorModelSet(hw)
    fabric = None
    if graph.fabric is not None and graph.fabric.mode != "none":
        if transfer_overlap > 0.0:
            raise ValueError(
                "fabric contention and layer-streamed KV transfer "
                "(transfer_overlap > 0) cannot be combined: streamed "
                "chunks are priced against a dedicated link, not the "
                "shared fabric")
        fabric = Fabric(engine, graph.fabric)
    routing = resolve_router(routing)
    mem_cls, mem_kw = resolve_memory(memory)
    qpolicy = resolve_scheduler(queue_policy)
    default_pipe = resolve_pipeline(pipeline)
    metrics = MetricsCollector()
    mode = graph.mode

    pred0 = ExecutionPredictor(cfg, graph.clusters[0].par, hw, ops)
    controller = GlobalController(
        engine, mode=mode, clusters={},
        kv_bytes_per_token=pred0.kv_bytes_per_token(),
        transfer_bw=transfer_bw if transfer_bw is not None
        else hw.inter_node_bw,
        metrics=metrics, links=graph.link_table(),
        entry=graph.entry_clusters,
        kv_layers=pred0.kv_layer_count(),
        transfer_overlap=transfer_overlap,
        fabric=fabric)
    hooks = controller.hooks()

    clusters: Dict[str, ClusterWorker] = {}
    n_devices = 0
    for spec in graph.clusters:
        hw_c = spec.hardware or hw
        ops_c = ops if spec.hardware is None else OperatorModelSet(hw_c)
        if fabric is not None:
            # the cluster's NIC uplink joins the shared fabric, and its
            # inter-node collective terms are re-priced fabric-aware
            fabric.attach(spec.name, hw_c.inter_node_bw)
            ops_c = FabricOps(ops_c, fabric.config, fabric)
        prefix = spec.replica_prefix or spec.name
        pipe = spec.pipeline if spec.pipeline is not None else default_pipe
        policy = spec.policy
        if (policy is None and pipe is not None and pipe.chunked_prefill
                and spec.role in ("prefill", "colocated")):
            # chunked-prefill strategy: the role-default batching policy
            # becomes Sarathi-style chunking at the configured budget
            policy = ChunkedPrefill(chunk=pipe.prefill_chunk)
        replicas = []
        for i in range(spec.n_replicas):
            rseed = seed + spec.seed_offset + i
            if spec.step == "af":
                remote_ops = (OperatorModelSet(spec.expert_cluster_hw)
                              if spec.expert_cluster_hw is not None else None)
                link = spec.expert_link
                if link is None and spec.remote_expert_ranks:
                    link = LinkSpec(spec.name, f"{spec.name}-experts",
                                    bandwidth=hw_c.inter_node_bw)
                pred = AFPipelinePredictor(
                    cfg, spec.par, hw_c, ops_c, routing=routing, seed=rseed,
                    memoize=spec.memoize,
                    m=spec.m, attn_par=spec.attn_par or spec.par,
                    ffn_par=spec.ffn_par or spec.par,
                    remote_ranks=spec.remote_expert_ranks,
                    remote_link=link, remote_ops=remote_ops,
                    pipeline=pipe)
            else:
                pred = ExecutionPredictor(cfg, spec.par, hw_c, ops_c,
                                          routing=routing, seed=rseed,
                                          memoize=spec.memoize)
            mem = mem_cls(_kv_budget(cfg, hw_c, spec.par, pred, frac=kv_frac),
                          pred.kv_bytes_per_token(), **mem_kw)
            replicas.append(ReplicaWorker(
                engine, f"{prefix}{i}", pred,
                policy or _default_policy(spec.role),
                mem, hooks, role=spec.role, queue_policy=qpolicy,
                pipeline=pipe))
        cluster = ClusterWorker(spec.name, spec.role, replicas)
        cluster.spec = spec
        cluster.hw = hw_c
        clusters[spec.name] = cluster
        n_devices += spec.n_replicas * spec.devices_per_replica()

    controller.clusters.update(clusters)
    return SystemHandle(engine, controller, clusters, n_devices,
                        fabric=fabric)
