"""SimSpec: the fully serializable description of one simulation experiment.

A spec is a plain dataclass tree — model reference, topology (preset or
inline StageGraph), workload, policies (all resolved by registry name),
operator models, SLOs, fault injections, seed — that round-trips through
dict/JSON/YAML and validates at build time with actionable errors.  It is
the single declarative front door to the simulator:

    spec = SimSpec(model=ModelRef("qwen2-7b"),
                   topology=TopologySpec(preset="pd", n_prefill=1,
                                         n_decode=2),
                   workload=WorkloadSpec(n_requests=200, rate=12.0))
    report = repro_torch.api.run(spec)

or, from JSON (the card's machine has no PyYAML)::

    report = repro_torch.api.run(SimSpec.load("examples_torch/specs/quickstart.json"))

Everything in a spec is data (names, numbers, lists) so specs hash
(`spec_hash`), pickle across process pools (`repro_torch.api.sweep`), and diff
in version control.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

from repro_torch.configs import REGISTRY
from repro_torch.core.hardware import HARDWARE, HardwareSpec, LinkSpec, \
    ParallelismConfig
from repro_torch.core.opmodels import OPMODELS
from repro_torch.core.pipeline import (
    AF_OVERLAP_MODES, PIPELINES, PipelineConfig, resolve_pipeline,
)
from repro_torch.core.policies.batching import resolve_batching
from repro_torch.core.policies.memory import PREEMPTION_MODES, resolve_memory
from repro_torch.core.policies.scheduling import resolve_scheduler
from repro_torch.core.routing import resolve_router
from repro_torch.core.topology import ClusterSpec, ROLES, StageGraph
from repro_torch.workload.generator import ARRIVALS, RATE_CURVES

PRESETS = ("colocated", "pd", "af")
LENGTH_KINDS = ("fixed", "uniform", "lognormal", "bimodal")
FAULT_KINDS = ("failure", "straggler")


class SpecError(ValueError):
    """A spec failed validation; the message names the offending path."""


def _from_mapping(cls, data: Any, path: str):
    """Build dataclass ``cls`` from a mapping, rejecting unknown keys."""
    if data is None or isinstance(data, cls):
        return data
    if not isinstance(data, Mapping):
        raise SpecError(f"{path}: expected a mapping for {cls.__name__}, "
                        f"got {type(data).__name__}")
    known = {f.name for f in fields(cls)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise SpecError(f"{path}: unknown field(s) {unknown}; "
                        f"known: {sorted(known)}")
    return cls(**dict(data))


def _coerce(obj: Any, kind: type, *names: str) -> None:
    """Coerce numeric fields in place (YAML 1.1 reads '2.5e10' as a str)."""
    for n in names:
        v = getattr(obj, n)
        if v is None or isinstance(v, kind):
            continue
        try:
            setattr(obj, n, kind(v))
        except (TypeError, ValueError) as e:
            raise SpecError(f"{type(obj).__name__.lower()}.{n}: expected "
                            f"{kind.__name__}, got {v!r}") from e


def _resolve_hw(hw: Union[str, HardwareSpec], path: str) -> HardwareSpec:
    if isinstance(hw, HardwareSpec):
        return hw
    if hw not in HARDWARE:
        raise SpecError(f"{path}: unknown hardware {hw!r}; "
                        f"available: {sorted(HARDWARE)}")
    return HARDWARE[hw]


# --------------------------------------------------------------- model ----
@dataclass
class ModelRef:
    """A model architecture by registry name (see ``repro_torch.configs``)."""
    name: str = "qwen2-7b"
    smoke: bool = False      # reduced same-family variant (CI-sized)

    def validate(self) -> None:
        if self.name not in REGISTRY:
            raise SpecError(f"model.name: unknown model {self.name!r}; "
                            f"available: {sorted(REGISTRY)}")


# ------------------------------------------------------------ topology ----
@dataclass
class FabricSpec:
    """Shared network fabric (see ``repro_torch.core.fabric``).

    ``mode: none`` (the default) keeps the legacy isolated point-to-point
    link pricing bit-identically; ``mode: shared`` attaches every
    cluster's NIC uplink to a common fabric where concurrent transfers
    split effective bandwidth processor-sharing style and inter-node
    collectives are re-priced topology-aware (``collective``: ring or
    tree, with ``latency_s`` per hop).  ``oversubscription`` divides every
    uplink's capacity (2.0 = a 2:1 oversubscribed spine);
    ``uplink_bw`` overrides the per-cluster uplink (default: each
    cluster's ``inter_node_bw``).
    """
    mode: str = "none"
    oversubscription: float = 1.0
    latency_s: float = 0.0
    collective: str = "ring"
    uplink_bw: Optional[float] = None

    def __post_init__(self) -> None:
        _coerce(self, float, "oversubscription", "latency_s", "uplink_bw")

    def to_config(self):
        from repro_torch.core.fabric import FabricConfig
        return FabricConfig(mode=self.mode,
                            oversubscription=self.oversubscription,
                            latency_s=self.latency_s,
                            collective=self.collective,
                            uplink_bw=self.uplink_bw)

    def validate(self) -> None:
        try:
            self.to_config().validate()
        except ValueError as e:
            raise SpecError(f"topology.fabric: {e}") from e


_CLUSTER_KEYS = {
    "name", "role", "n_replicas", "tp", "pp", "ep", "hardware", "step",
    "m", "attn_tp", "ffn_tp", "ffn_ep", "remote_expert_ranks",
    "expert_cluster_hw", "expert_link_bw", "expert_link_latency",
    "batching", "seed_offset", "replica_prefix", "memoize", "pipeline",
}
_LINK_KEYS = {"src", "dst", "bandwidth", "latency"}


@dataclass
class TopologySpec:
    """Preset topology with knobs, or an inline cluster/link graph.

    ``preset`` is one of "colocated" | "pd" | "af" (compiled through the
    corresponding ``build_*`` preset); ``preset=None`` takes the inline
    ``clusters``/``links`` dicts and compiles them to a ``StageGraph``.
    """
    preset: Optional[str] = "colocated"
    hardware: str = "A800-SXM4-80G"
    transfer_bw: Optional[float] = None   # flat KV-transfer fallback (B/s)
    memoize: bool = True                  # step-time memo cache
    # colocated knobs
    n_replicas: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    # pd knobs (also the prefill side of "af")
    n_prefill: int = 1
    n_decode: int = 1
    prefill_tp: int = 1
    decode_tp: int = 1
    # af knobs
    m: int = 2
    attn_tp: int = 1
    ffn_tp: int = 1
    ffn_ep: int = 1
    remote_expert_ranks: List[int] = field(default_factory=list)
    expert_cluster_hw: Optional[str] = None
    expert_link_bw: Optional[float] = None
    expert_link_latency: float = 0.0
    # inline graph (preset=None)
    clusters: Optional[List[Dict[str, Any]]] = None
    links: Optional[List[Dict[str, Any]]] = None
    # shared-fabric contention (None == {"mode": "none"} == legacy pricing)
    fabric: Optional[FabricSpec] = None
    # per-hardware-name $/GPU-hr overrides, e.g. {"H100-SXM": 4.5};
    # None keeps each HardwareSpec's built-in dollars_per_hour
    dollars_per_hour: Optional[Dict[str, float]] = None

    def __post_init__(self) -> None:
        _coerce(self, float, "transfer_bw", "expert_link_bw",
                "expert_link_latency")
        _coerce(self, int, "n_replicas", "tp", "pp", "ep", "n_prefill",
                "n_decode", "prefill_tp", "decode_tp", "m", "attn_tp",
                "ffn_tp", "ffn_ep")
        self.remote_expert_ranks = [int(r) for r in self.remote_expert_ranks]
        if isinstance(self.fabric, str):
            self.fabric = FabricSpec(mode=self.fabric)
        elif isinstance(self.fabric, Mapping):
            self.fabric = _from_mapping(FabricSpec, self.fabric,
                                        "topology.fabric")

    def fabric_config(self):
        """The core ``FabricConfig`` for build time; None when unset or
        mode == "none" (the builders then skip fabric construction)."""
        if self.fabric is None or self.fabric.mode == "none":
            return None
        return self.fabric.to_config()

    def hw_pricing(self, hw: HardwareSpec) -> HardwareSpec:
        """Apply any ``dollars_per_hour`` override for this hardware."""
        if self.dollars_per_hour and hw.name in self.dollars_per_hour:
            return hw.with_(
                dollars_per_hour=float(self.dollars_per_hour[hw.name]))
        return hw

    # ------------------------------------------------------- validation --
    def validate(self) -> None:
        _resolve_hw(self.hardware, "topology.hardware")
        if self.fabric is not None:
            self.fabric.validate()
        if self.transfer_bw is not None and self.transfer_bw <= 0:
            raise SpecError(f"topology.transfer_bw: must be > 0 "
                            f"(a zero-bandwidth link would price KV "
                            f"transfers as free), got {self.transfer_bw}")
        if self.dollars_per_hour is not None:
            if not isinstance(self.dollars_per_hour, Mapping):
                raise SpecError(
                    "topology.dollars_per_hour: expected a mapping of "
                    "hardware name -> $/GPU-hr, got "
                    f"{type(self.dollars_per_hour).__name__}")
            for k, v in self.dollars_per_hour.items():
                _resolve_hw(k, f"topology.dollars_per_hour[{k!r}]")
                try:
                    rate = float(v)
                except (TypeError, ValueError):
                    raise SpecError(
                        f"topology.dollars_per_hour[{k!r}]: expected a "
                        f"number, got {v!r}") from None
                if rate < 0:
                    raise SpecError(f"topology.dollars_per_hour[{k!r}]: "
                                    f"must be >= 0, got {rate}")
        if self.preset is None:
            if not self.clusters:
                raise SpecError("topology: preset=None needs inline "
                                "'clusters' (or pick a preset from "
                                f"{PRESETS})")
            self.inline_graph().validate()
            return
        if self.preset not in PRESETS:
            raise SpecError(f"topology.preset: unknown preset "
                            f"{self.preset!r}; available: {PRESETS} "
                            f"(or None with inline clusters)")
        if self.clusters or self.links:
            raise SpecError("topology: inline 'clusters'/'links' require "
                            "preset=None (they are ignored by presets)")
        for knob in ("n_replicas", "tp", "pp", "ep", "n_prefill",
                     "n_decode", "prefill_tp", "decode_tp", "m",
                     "attn_tp", "ffn_tp", "ffn_ep"):
            if getattr(self, knob) < 1:
                raise SpecError(f"topology.{knob}: must be >= 1, "
                                f"got {getattr(self, knob)}")
        if self.expert_cluster_hw is not None:
            _resolve_hw(self.expert_cluster_hw, "topology.expert_cluster_hw")
        if self.remote_expert_ranks:
            if self.preset != "af":
                raise SpecError("topology.remote_expert_ranks: only the "
                                "'af' preset places experts remotely")
            ep = max(self.ffn_ep, self.ffn_tp, 1)
            bad = [r for r in self.remote_expert_ranks if not 0 <= r < ep]
            if bad:
                raise SpecError(f"topology.remote_expert_ranks: ranks {bad} "
                                f"out of range for ffn_ep={ep}")
        elif self.expert_cluster_hw or self.expert_link_bw:
            raise SpecError("topology: expert_cluster_hw/expert_link_bw "
                            "have no effect without remote_expert_ranks")
        if self.expert_link_bw is not None and self.expert_link_bw <= 0:
            raise SpecError(f"topology.expert_link_bw: must be > 0, "
                            f"got {self.expert_link_bw}")

    def cluster_names(self) -> List[str]:
        if self.preset == "colocated":
            return ["colocated"]
        if self.preset in ("pd", "af"):
            return ["prefill", "decode"]
        return [c.get("name", "?") for c in (self.clusters or [])]

    # ----------------------------------------------------- inline graph --
    def inline_graph(self, batching=None) -> StageGraph:
        """Compile inline cluster/link dicts to a core StageGraph.

        ``batching`` is an optional per-role/per-name resolver (see
        ``PolicySpec.batching_for``) applied where a cluster dict does not
        carry its own ``batching`` entry.
        """
        clusters = []
        for i, c in enumerate(self.clusters or []):
            path = f"topology.clusters[{i}]"
            if not isinstance(c, Mapping):
                raise SpecError(f"{path}: expected a mapping")
            unknown = sorted(set(c) - _CLUSTER_KEYS)
            if unknown:
                raise SpecError(f"{path}: unknown field(s) {unknown}; "
                                f"known: {sorted(_CLUSTER_KEYS)}")
            if "name" not in c or "role" not in c:
                raise SpecError(f"{path}: 'name' and 'role' are required")
            if c["role"] not in ROLES:
                raise SpecError(f"{path}.role: unknown role {c['role']!r}; "
                                f"available: {ROLES}")
            name = c["name"]
            par = ParallelismConfig(tp=int(c.get("tp", 1)),
                                    pp=int(c.get("pp", 1)),
                                    ep=int(c.get("ep", 1)))
            step = c.get("step", "dense")
            attn_par = (ParallelismConfig(tp=int(c["attn_tp"]))
                        if "attn_tp" in c else None)
            ffn_par = (ParallelismConfig(tp=int(c.get("ffn_tp", 1)),
                                         ep=int(c.get("ffn_ep", 1)))
                       if ("ffn_tp" in c or "ffn_ep" in c) else None)
            link = None
            if c.get("expert_link_bw") is not None:
                link = LinkSpec(name, f"{name}-experts",
                                bandwidth=float(c["expert_link_bw"]),
                                latency=float(c.get("expert_link_latency",
                                                    0.0)))
            try:
                policy = resolve_batching(
                    c["batching"] if "batching" in c
                    else (batching(c["role"], name) if batching else None))
            except (KeyError, TypeError) as e:
                raise SpecError(f"{path}.batching: {e}") from e
            try:
                pipe = resolve_pipeline(c.get("pipeline"))
            except (KeyError, TypeError, ValueError) as e:
                raise SpecError(f"{path}.pipeline: {e}") from e
            clusters.append(ClusterSpec(
                name=name, role=c["role"],
                n_replicas=int(c.get("n_replicas", 1)), par=par,
                hardware=(_resolve_hw(c["hardware"], f"{path}.hardware")
                          if "hardware" in c else None),
                policy=policy, step=step, m=int(c.get("m", 2)),
                attn_par=attn_par, ffn_par=ffn_par,
                remote_expert_ranks=tuple(
                    int(r) for r in c.get("remote_expert_ranks", ())),
                expert_cluster_hw=(
                    _resolve_hw(c["expert_cluster_hw"],
                                f"{path}.expert_cluster_hw")
                    if c.get("expert_cluster_hw") else None),
                expert_link=link,
                seed_offset=int(c.get("seed_offset", 100 * i)),
                replica_prefix=c.get("replica_prefix"),
                memoize=bool(c.get("memoize", self.memoize)),
                pipeline=pipe))
        links = []
        for i, l in enumerate(self.links or []):
            path = f"topology.links[{i}]"
            if not isinstance(l, Mapping):
                raise SpecError(f"{path}: expected a mapping")
            unknown = sorted(set(l) - _LINK_KEYS)
            if unknown:
                raise SpecError(f"{path}: unknown field(s) {unknown}; "
                                f"known: {sorted(_LINK_KEYS)}")
            if "src" not in l or "dst" not in l or "bandwidth" not in l:
                raise SpecError(f"{path}: 'src', 'dst' and 'bandwidth' are "
                                f"required")
            bw = float(l["bandwidth"])
            if bw <= 0:
                raise SpecError(
                    f"{path}.bandwidth: must be > 0 bytes/s, got {bw} — "
                    f"a zero-bandwidth link would silently price its "
                    f"transfers as free; use a large finite bandwidth to "
                    f"model a negligible-cost link")
            links.append(LinkSpec(l["src"], l["dst"], bandwidth=bw,
                                  latency=float(l.get("latency", 0.0))))
        graph = StageGraph(clusters=clusters, links=links,
                           fabric=self.fabric_config())
        try:
            graph.validate()
        except ValueError as e:
            raise SpecError(f"topology: {e}") from e
        return graph


# ------------------------------------------------------------ workload ----
@dataclass
class WorkloadSpec:
    """Wraps ``workload.generator.WorkloadConfig`` + trace-file replay."""
    n_requests: int = 100
    arrival: str = "poisson"       # poisson | uniform | burst | closed
    rate: float = 4.0
    prompt: str = "lognormal"      # fixed | uniform | lognormal | bimodal
    prompt_mean: int = 512
    prompt_max: int = 8192
    output: str = "lognormal"
    output_mean: int = 128
    output_max: int = 2048
    burst_size: int = 32           # arrival="burst": requests per burst
    burst_period: float = 1.0      # arrival="burst": seconds between bursts
    concurrency: Optional[int] = None   # arrival="closed": in-flight cap
    prefix_groups: int = 0         # shared-prefix trace: system-prompt pools
    prefix_len: int = 0            # shared tokens per group
    turns: int = 1                 # multi-turn conversations (growing prefix)
    turn_gap: float = 5.0          # seconds between a conversation's turns
    rate_curve: Optional[str] = None   # "diurnal": sinusoidal rate swing
    rate_period: float = 60.0      # seconds per diurnal cycle
    rate_amplitude: float = 0.5    # relative swing, in [0, 1)
    trace: Optional[str] = None    # JSONL replay path (overrides generator)
    seed: Optional[int] = None     # None -> SimSpec.seed

    def __post_init__(self) -> None:
        _coerce(self, float, "rate", "burst_period", "turn_gap",
                "rate_period", "rate_amplitude")
        _coerce(self, int, "n_requests", "prompt_mean", "prompt_max",
                "output_mean", "output_max", "burst_size", "concurrency",
                "prefix_groups", "prefix_len", "turns", "seed")

    def validate(self) -> None:
        if self.arrival not in ARRIVALS:
            raise SpecError(f"workload.arrival: unknown process "
                            f"{self.arrival!r}; available: {ARRIVALS}")
        if self.arrival == "closed" and (self.concurrency is None
                                         or self.concurrency < 1):
            raise SpecError(
                "workload.concurrency: closed-loop arrivals need a "
                "concurrency >= 1 (the in-flight request cap; the next "
                "request arrives when a slot frees)")
        if self.arrival in ("poisson", "uniform") and self.rate <= 0:
            raise SpecError(f"workload.rate: open-loop arrivals need "
                            f"rate > 0, got {self.rate}")
        for fld in ("prompt", "output"):
            if getattr(self, fld) not in LENGTH_KINDS:
                raise SpecError(f"workload.{fld}: unknown length "
                                f"distribution {getattr(self, fld)!r}; "
                                f"available: {LENGTH_KINDS}")
        if self.n_requests < 1:
            raise SpecError(f"workload.n_requests: must be >= 1, "
                            f"got {self.n_requests}")
        if self.prefix_groups < 0 or self.prefix_len < 0:
            raise SpecError("workload.prefix_groups/prefix_len: must be "
                            ">= 0")
        if self.prefix_groups > 0 and self.prefix_len < 1:
            raise SpecError("workload.prefix_len: shared-prefix workloads "
                            "(prefix_groups > 0) need prefix_len >= 1")
        if self.turns < 1:
            raise SpecError(f"workload.turns: must be >= 1, got {self.turns}")
        if self.turns > 1 and self.prefix_groups > 0:
            raise SpecError("workload: turns > 1 and prefix_groups > 0 are "
                            "mutually exclusive (conversation prefixes "
                            "already share)")
        if self.rate_curve is not None:
            if self.rate_curve not in RATE_CURVES:
                raise SpecError(f"workload.rate_curve: unknown curve "
                                f"{self.rate_curve!r}; available: "
                                f"{RATE_CURVES}")
            if self.arrival != "poisson":
                raise SpecError("workload.rate_curve: rate curves modulate "
                                "the poisson arrival process; got "
                                f"arrival={self.arrival!r}")
            if not 0.0 <= self.rate_amplitude < 1.0:
                raise SpecError(f"workload.rate_amplitude: must be in "
                                f"[0, 1), got {self.rate_amplitude}")
            if self.rate_period <= 0:
                raise SpecError(f"workload.rate_period: must be > 0, "
                                f"got {self.rate_period}")
        if self.turns > 1 and self.arrival == "closed":
            raise SpecError(
                "workload.arrival: closed-loop injection re-stamps arrivals "
                "in queue order, putting a conversation's later turns in "
                "flight before their history is generated — use an "
                "open-loop arrival process with turns > 1")

    def build_requests(self, default_seed: int = 0):
        from repro_torch.workload.generator import WorkloadConfig, generate, \
            load_trace
        if self.trace is not None:
            return load_trace(self.trace, n_requests=self.n_requests)
        return generate(WorkloadConfig(
            n_requests=self.n_requests, arrival=self.arrival,
            rate=self.rate, prompt=self.prompt,
            prompt_mean=self.prompt_mean, prompt_max=self.prompt_max,
            output=self.output, output_mean=self.output_mean,
            output_max=self.output_max, burst_size=self.burst_size,
            burst_period=self.burst_period, concurrency=self.concurrency,
            prefix_groups=self.prefix_groups, prefix_len=self.prefix_len,
            turns=self.turns, turn_gap=self.turn_gap,
            rate_curve=self.rate_curve, rate_period=self.rate_period,
            rate_amplitude=self.rate_amplitude,
            seed=self.seed if self.seed is not None else default_seed))


# ------------------------------------------------------------ policies ----
@dataclass
class PolicySpec:
    """Registry-name policy selection, resolved uniformly at build time.

    ``batching`` is either one policy for every cluster (name or
    ``{"name": ..., **kwargs}``) or a mapping keyed by role
    (``{"prefill": "continuous", "decode": {"name": "chunked_prefill",
    "chunk": 256}}``).  ``router`` picks the MoE routing module,
    ``scheduler`` the queue-ordering policy, ``memory`` the KV manager.
    """
    router: Union[None, str, Dict[str, Any]] = None
    batching: Union[None, str, Dict[str, Any]] = None
    scheduler: Union[None, str, Dict[str, Any]] = None
    memory: Union[None, str, Dict[str, Any]] = None

    def _role_keyed(self) -> bool:
        return (isinstance(self.batching, Mapping)
                and "name" not in self.batching)

    def batching_for(self, role: str, name: str = "") \
            -> Union[None, str, Dict[str, Any]]:
        if self._role_keyed():
            return self.batching.get(name, self.batching.get(role))
        return self.batching

    def validate(self) -> None:
        try:
            resolve_router(self.router)
        except (KeyError, TypeError) as e:
            raise SpecError(f"policy.router: {e}") from e
        try:
            if self._role_keyed():
                # keys are roles (or cluster names for inline graphs);
                # every value must itself resolve
                for v in self.batching.values():
                    resolve_batching(v)
            else:
                resolve_batching(self.batching)
        except (KeyError, TypeError) as e:
            raise SpecError(f"policy.batching: {e}") from e
        try:
            resolve_scheduler(self.scheduler)
        except (KeyError, TypeError) as e:
            raise SpecError(f"policy.scheduler: {e}") from e
        try:
            resolve_memory(self.memory)
        except (KeyError, TypeError) as e:
            raise SpecError(f"policy.memory: {e}") from e


@dataclass
class PipelineSpec:
    """Latency-hiding pipelining strategy (see ``repro_torch.core.pipeline``).

    ``preset`` starts from a registered strategy (``"serial"``,
    ``"two_batch"``, ``"chunked_prefill"``, ``"ep_overlap"``,
    ``"full_overlap"``); explicitly-set fields override it.  With no
    preset the fields stand alone.  A spec with ``pipeline: null`` (the
    default) keeps the legacy serial-per-micro-batch model bit-for-bit.

    - ``af_overlap``: AF decode-step resource model — ``"none"`` (legacy),
      ``"serial"`` (no-latency-hiding baseline), ``"two_batch"``
      (ping-pong with per-direction NIC lanes).
    - ``chunked_prefill`` / ``prefill_chunk``: Sarathi-style chunked
      prefill with piggybacked decode on colocated and PD prefill pools.
    - ``ep_overlap``: EP dispatch/combine comm-compute overlap efficiency.
    """
    preset: Optional[str] = None
    af_overlap: Optional[str] = None      # None -> preset / "none"
    nic_lanes: Optional[int] = None
    chunked_prefill: Optional[bool] = None
    prefill_chunk: Optional[int] = None
    ep_overlap: Optional[float] = None

    def __post_init__(self) -> None:
        _coerce(self, int, "nic_lanes", "prefill_chunk")
        _coerce(self, float, "ep_overlap")

    def to_config(self) -> PipelineConfig:
        overrides = {k: v for k, v in (
            ("af_overlap", self.af_overlap),
            ("nic_lanes", self.nic_lanes),
            ("chunked_prefill", self.chunked_prefill),
            ("prefill_chunk", self.prefill_chunk),
            ("ep_overlap", self.ep_overlap)) if v is not None}
        # one merge implementation: resolve_pipeline raises on unknown
        # presets rather than silently compiling to the no-op config
        if self.preset is not None:
            return resolve_pipeline({"name": self.preset, **overrides})
        return resolve_pipeline(overrides) if overrides \
            else PipelineConfig()

    def validate(self) -> None:
        if self.preset is not None and self.preset not in PIPELINES:
            raise SpecError(f"pipeline.preset: unknown preset "
                            f"{self.preset!r}; available: "
                            f"{sorted(PIPELINES)}")
        if self.af_overlap is not None \
                and self.af_overlap not in AF_OVERLAP_MODES:
            raise SpecError(f"pipeline.af_overlap: unknown mode "
                            f"{self.af_overlap!r}; available: "
                            f"{AF_OVERLAP_MODES}")
        try:
            self.to_config().validate()
        except (KeyError, ValueError) as e:
            raise SpecError(f"pipeline: {e}") from e


@dataclass
class MemorySpec:
    """The KV-cache memory subsystem: manager, preemption, transfer.

    - ``manager``: registered KV manager — ``"paged"`` (vLLM-style blocks),
      ``"prefix"`` (radix prefix cache with block sharing + LRU eviction),
      ``"monolithic"`` (per-request max-bound reservation) — or a mapping
      ``{"name": ..., **kwargs}`` (block_tokens, watermark, ...).
    - ``preemption``: what a decode OOM does to the evicted request —
      ``"recompute"`` (drop KV, re-prefill the context through an entry
      cluster) or ``"swap"`` (move KV to host over ``swap_bw`` and restore
      in place when blocks free).
    - ``transfer_overlap``: layer-wise streamed PD KV transfer — the
      fraction of the streaming opportunity realized; 0 keeps the legacy
      lump-sum transfer bit-for-bit.
    - ``capacity_frac``: fraction of post-weight HBM given to the KV cache
      (the cache-size knob for memory-pressure sweeps; default 0.9).
    """
    manager: Union[None, str, Dict[str, Any]] = None
    preemption: str = "recompute"
    swap_bw: float = 32e9
    transfer_overlap: float = 0.0
    capacity_frac: float = 0.9

    def __post_init__(self) -> None:
        _coerce(self, float, "swap_bw", "transfer_overlap", "capacity_frac")

    def manager_mapping(self) -> Dict[str, Any]:
        """The mapping build_system's ``memory=`` argument takes (manager
        name + kwargs + the preemption policy that travels with it)."""
        m = self.manager
        if m is None:
            m = {"name": "paged"}
        elif isinstance(m, str):
            m = {"name": m}
        else:
            m = dict(m)
        m.setdefault("preemption", self.preemption)
        m.setdefault("swap_bw", self.swap_bw)
        return m

    def validate(self) -> None:
        if self.preemption not in PREEMPTION_MODES:
            raise SpecError(f"memory.preemption: unknown mode "
                            f"{self.preemption!r}; available: "
                            f"{PREEMPTION_MODES}")
        if not 0.0 <= self.transfer_overlap <= 1.0:
            raise SpecError(f"memory.transfer_overlap: must be in [0, 1], "
                            f"got {self.transfer_overlap}")
        if not 0.0 < self.capacity_frac <= 1.0:
            raise SpecError(f"memory.capacity_frac: must be in (0, 1], "
                            f"got {self.capacity_frac}")
        if self.swap_bw <= 0:
            raise SpecError(f"memory.swap_bw: must be > 0, "
                            f"got {self.swap_bw}")
        try:
            resolve_memory(self.manager_mapping())
        except (KeyError, TypeError) as e:
            raise SpecError(f"memory.manager: {e}") from e


PREDICTOR_BACKENDS = ("python", "numpy", "jit")


@dataclass
class OpModelSpec:
    """Operator-model family for the ExecutionPredictor.

    ``backend`` selects the step-cost evaluation path: ``python`` (default)
    walks the operator graph per step with a full parts breakdown;
    ``numpy`` prices cache-miss steps through the vectorized fused
    roofline kernel; ``jit`` evaluates that kernel as one float32 torch
    expression on the device ``run``/``build`` are given (totals match
    python to float32 rounding, not bitwise).  Models the kernel can't
    reproduce (MoE routing draws, refined operator models) silently fall
    back to python.

    ``calibration`` points at a directory of fitted artifacts produced by
    ``python -m repro_torch calibrate`` (the calib root or a ``<hardware>/``
    subdirectory); steps are then priced by the fitted forest models.
    Requires ``name: refined`` — the fitted models slot into the refined
    model set, with virtual kernels as the out-of-domain fallback.
    """
    name: str = "analytical"
    backend: str = "python"
    calibration: Optional[str] = None

    def validate(self) -> None:
        if self.name not in OPMODELS:
            raise SpecError(f"opmodel.name: unknown operator model "
                            f"{self.name!r}; available: {sorted(OPMODELS)}")
        if self.backend not in PREDICTOR_BACKENDS:
            raise SpecError(f"opmodel.backend: unknown predictor backend "
                            f"{self.backend!r}; available: "
                            f"{list(PREDICTOR_BACKENDS)}")
        if self.calibration is not None:
            if not isinstance(self.calibration, str) or not self.calibration:
                raise SpecError("opmodel.calibration: expected a path to a "
                                "calibration artifact directory (see "
                                "`python -m repro_torch calibrate`)")
            if self.name != "refined":
                raise SpecError(
                    f"opmodel.calibration: fitted artifacts load into the "
                    f"refined model set; set opmodel.name: refined "
                    f"(got {self.name!r})")


@dataclass
class SLOSpec:
    """Service-level objectives; enables goodput/attainment in the Report."""
    ttft_s: float = 1.0
    tpot_s: float = 0.1

    def __post_init__(self) -> None:
        _coerce(self, float, "ttft_s", "tpot_s")

    def validate(self) -> None:
        if self.ttft_s <= 0 or self.tpot_s <= 0:
            raise SpecError(f"slo: ttft_s/tpot_s must be > 0, got "
                            f"({self.ttft_s}, {self.tpot_s})")


@dataclass
class FaultSpec:
    """One injected fault: a replica failure or a chronic straggler."""
    kind: str = "failure"          # "failure" | "straggler"
    cluster: str = "colocated"
    replica: int = 0
    at: float = 0.0                # failure: injection time (s)
    downtime: float = 10.0         # failure: recovery delay (s)
    slowdown: float = 1.0          # straggler: step-time multiplier
    instance: Optional[str] = None  # fleet runs: target instance (default:
    #                                 the first instance of the fleet)

    def __post_init__(self) -> None:
        _coerce(self, float, "at", "downtime", "slowdown")
        _coerce(self, int, "replica")

    def validate(self, cluster_names: Sequence[str], path: str) -> None:
        if self.kind not in FAULT_KINDS:
            raise SpecError(f"{path}.kind: unknown fault kind "
                            f"{self.kind!r}; available: {FAULT_KINDS}")
        if self.cluster not in cluster_names:
            raise SpecError(f"{path}.cluster: unknown cluster "
                            f"{self.cluster!r}; topology has "
                            f"{list(cluster_names)}")
        if self.replica < 0:
            raise SpecError(f"{path}.replica: must be >= 0")
        if self.kind == "straggler" and self.slowdown <= 0:
            raise SpecError(f"{path}.slowdown: must be > 0, "
                            f"got {self.slowdown}")


# ------------------------------------------------------------------ obs ----
@dataclass
class ObsSpec:
    """Observability (see ``repro_torch.obs``): request spans, sim-time
    counters, and trace export.

    Off unless the spec carries this section (``obs: {}`` enables
    everything but EP spans).  ``ep_spans`` additionally records the
    per-EP-rank dispatch/rank/combine markers of AF decode steps by
    running cache-miss steps through the traced inner engine
    (bit-identical timings, slower stepping).  ``max_spans`` /
    ``max_counter_points`` bound recorder memory: beyond the span cap
    new spans are counted as dropped, and counter series are windowed
    down by merging adjacent samples.
    """
    enabled: bool = True
    spans: bool = True
    counters: bool = True
    ep_spans: bool = False
    max_spans: int = 500_000
    max_counter_points: int = 4096
    top_n: int = 5                 # summary sink: top-N slowest requests

    def __post_init__(self) -> None:
        _coerce(self, int, "max_spans", "max_counter_points", "top_n")

    def validate(self) -> None:
        if self.max_spans < 0:
            raise SpecError(f"obs.max_spans: must be >= 0, "
                            f"got {self.max_spans}")
        if self.max_counter_points < 2:
            raise SpecError(f"obs.max_counter_points: must be >= 2, "
                            f"got {self.max_counter_points}")
        if self.top_n < 1:
            raise SpecError(f"obs.top_n: must be >= 1, got {self.top_n}")

    @classmethod
    def parse(cls, data: Any) -> Optional["ObsSpec"]:
        """``obs: true`` / ``obs: off`` booleans are accepted as YAML
        shorthand for the default-enabled / absent section."""
        if isinstance(data, bool):
            return cls() if data else None
        return _from_mapping(cls, data, "obs")


# ---------------------------------------------------------------- fleet ----
@dataclass
class InstanceSpec:
    """A group of identical serving instances inside a fleet.

    Each of the ``count`` instances is a FULL deployment (its own
    GlobalController, clusters, replicas, KV managers) built from
    ``topology`` — or the SimSpec's top-level topology when None — so a
    fleet mixes heterogeneous instance shapes freely (a PD pool next to
    colocated pools on different hardware).  ``pipeline``/``memory``
    override the spec-level sections for this group only.
    """
    name: str = "inst"
    count: int = 1
    topology: Optional[TopologySpec] = None
    pipeline: Optional[PipelineSpec] = None
    memory: Optional[MemorySpec] = None

    def __post_init__(self) -> None:
        _coerce(self, int, "count")


@dataclass
class TenantSpec:
    """One tenant class: traffic share, per-class SLOs, and priority.

    ``weight`` is the relative share of arrivals assigned to this class;
    ``priority`` (lower = more urgent) lands in the request's
    ``timestamps['priority']`` slot, so ``policy.scheduler: priority``
    makes tenant priority effective inside every instance.
    """
    name: str = "default"
    weight: float = 1.0
    ttft_s: Optional[float] = None     # per-class SLOs; None -> spec.slo
    tpot_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self) -> None:
        _coerce(self, float, "weight", "ttft_s", "tpot_s")
        _coerce(self, int, "priority")


@dataclass
class AutoscalerSpec:
    """SLO-driven fleet autoscaling (see ``repro_torch.fleet.autoscaler``).

    Every ``interval_s`` the autoscaler compares mean outstanding requests
    per active instance against ``up_queue_depth`` / ``down_queue_depth``
    and — when the spec carries an SLO — recent TTFT-SLO attainment against
    ``slo_attainment_floor``.  Scale-up provisions a clone of ``template``
    (an InstanceSpec name; default: the first group) with a modeled cold
    start: per-device weight bytes loaded over ``provision_bw`` plus
    ``startup_base_s``.  Scale-down drains: the victim stops receiving
    traffic, finishes its residents, then releases its GPUs.
    ``pd_rebalance`` additionally shifts replicas between the prefill and
    decode pools of disaggregated instances (via pre-provisioned standby
    replicas, ``pd_spares`` per pool) when one pool's queue pressure
    exceeds ``rebalance_ratio`` times the other's.
    """
    interval_s: float = 5.0
    min_instances: int = 1
    max_instances: int = 8
    up_queue_depth: float = 8.0
    down_queue_depth: float = 1.0
    slo_attainment_floor: Optional[float] = None
    cooldown_s: float = 10.0
    provision_bw: float = 16e9        # weight-load bandwidth (B/s/device)
    startup_base_s: float = 2.0       # container/runtime bring-up floor
    template: Optional[str] = None    # InstanceSpec name cloned on scale-up
    pd_rebalance: bool = False
    pd_spares: int = 1                # standby replicas per P/D pool
    rebalance_ratio: float = 4.0
    reconfigure_s: float = 1.0        # pool-move weight-load time

    def __post_init__(self) -> None:
        _coerce(self, float, "interval_s", "up_queue_depth",
                "down_queue_depth", "slo_attainment_floor", "cooldown_s",
                "provision_bw", "startup_base_s", "rebalance_ratio",
                "reconfigure_s")
        _coerce(self, int, "min_instances", "max_instances", "pd_spares")


@dataclass
class FleetSpec:
    """A multi-instance serving fleet behind one global router.

    ``instances`` lists heterogeneous instance groups; ``router`` names a
    registered fleet routing policy (``repro_torch.fleet.FLEET_ROUTERS``:
    round_robin | least_outstanding | power_of_two | prefix_affinity,
    optionally ``{"name": ..., **kwargs}``); ``autoscaler`` enables
    SLO-driven scaling; ``tenants`` declares tenant classes with per-class
    SLOs/priorities (requests are assigned by weighted draw).

    ``engine`` selects the fleet execution mode: ``serial`` (default)
    interleaves every instance on one event heap; ``windowed`` runs each
    instance on its own sub-engine, advancing all of them in conservative
    time windows of ``window_s`` seconds between fleet-level barriers —
    same arrivals, same routing decisions, deterministic given the window
    (``window_s == 0`` reproduces serial results exactly; larger windows
    trade cross-instance signal freshness for synchronization cost).
    """
    instances: List[InstanceSpec] = field(default_factory=list)
    router: Union[str, Dict[str, Any]] = "least_outstanding"
    autoscaler: Optional[AutoscalerSpec] = None
    tenants: List[TenantSpec] = field(default_factory=list)
    engine: str = "serial"
    window_s: float = 0.0

    def __post_init__(self) -> None:
        _coerce(self, float, "window_s")

    # ----------------------------------------------------------- parsing --
    @classmethod
    def parse(cls, data: Any, path: str = "fleet") -> Optional["FleetSpec"]:
        if data is None or isinstance(data, cls):
            return data
        if not isinstance(data, Mapping):
            raise SpecError(f"{path}: expected a mapping for FleetSpec, "
                            f"got {type(data).__name__}")
        d = dict(data)
        instances = []
        for i, inst in enumerate(d.get("instances") or []):
            ipath = f"{path}.instances[{i}]"
            inst = _from_mapping(InstanceSpec, inst, ipath)
            if isinstance(inst.topology, Mapping):
                inst.topology = _from_mapping(TopologySpec, inst.topology,
                                              f"{ipath}.topology")
            if isinstance(inst.pipeline, str):
                inst.pipeline = PipelineSpec(preset=inst.pipeline)
            elif isinstance(inst.pipeline, Mapping):
                inst.pipeline = _from_mapping(PipelineSpec, inst.pipeline,
                                              f"{ipath}.pipeline")
            if isinstance(inst.memory, str):
                inst.memory = MemorySpec(manager=inst.memory)
            elif isinstance(inst.memory, Mapping):
                inst.memory = _from_mapping(MemorySpec, inst.memory,
                                            f"{ipath}.memory")
            instances.append(inst)
        d["instances"] = instances
        d["autoscaler"] = _from_mapping(AutoscalerSpec, d.get("autoscaler"),
                                        f"{path}.autoscaler")
        d["tenants"] = [_from_mapping(TenantSpec, t, f"{path}.tenants[{i}]")
                        for i, t in enumerate(d.get("tenants") or [])]
        return _from_mapping(cls, d, path)

    # -------------------------------------------------------------- views --
    def instance_by_name(self, name: Optional[str]) -> InstanceSpec:
        if name is None:
            return self.instances[0]
        for inst in self.instances:
            if inst.name == name:
                return inst
        raise SpecError(f"fleet: unknown instance group {name!r}; "
                        f"groups: {[i.name for i in self.instances]}")

    def total_instances(self) -> int:
        return sum(i.count for i in self.instances)

    # --------------------------------------------------------- validation --
    def validate(self, default_topology: TopologySpec) -> None:
        from repro_torch.fleet.router import resolve_fleet_router
        if not self.instances:
            raise SpecError("fleet.instances: a fleet needs at least one "
                            "instance group")
        names = [i.name for i in self.instances]
        if len(set(names)) != len(names):
            raise SpecError(f"fleet.instances: duplicate group names "
                            f"{names}")
        for i, inst in enumerate(self.instances):
            if inst.count < 1:
                raise SpecError(f"fleet.instances[{i}].count: must be >= 1, "
                                f"got {inst.count}")
            (inst.topology or default_topology).validate()
            if inst.pipeline is not None:
                inst.pipeline.validate()
            if inst.memory is not None:
                inst.memory.validate()
        try:
            resolve_fleet_router(self.router)
        except (KeyError, TypeError) as e:
            raise SpecError(f"fleet.router: {e}") from e
        if self.engine not in ("serial", "windowed"):
            raise SpecError(f"fleet.engine: unknown engine mode "
                            f"{self.engine!r}; available: "
                            f"['serial', 'windowed']")
        if self.window_s < 0:
            raise SpecError(f"fleet.window_s: must be >= 0, "
                            f"got {self.window_s}")
        if self.autoscaler is not None:
            a = self.autoscaler
            if a.min_instances < 1 or a.max_instances < a.min_instances:
                raise SpecError(
                    f"fleet.autoscaler: need 1 <= min_instances <= "
                    f"max_instances, got ({a.min_instances}, "
                    f"{a.max_instances})")
            if a.interval_s <= 0 or a.cooldown_s < 0:
                raise SpecError("fleet.autoscaler: interval_s must be > 0 "
                                "and cooldown_s >= 0")
            if a.provision_bw <= 0:
                raise SpecError(f"fleet.autoscaler.provision_bw: must be "
                                f"> 0, got {a.provision_bw}")
            if a.slo_attainment_floor is not None \
                    and not 0.0 < a.slo_attainment_floor <= 1.0:
                raise SpecError(f"fleet.autoscaler.slo_attainment_floor: "
                                f"must be in (0, 1], got "
                                f"{a.slo_attainment_floor}")
            if a.pd_spares < 0 or a.rebalance_ratio <= 1.0:
                raise SpecError("fleet.autoscaler: pd_spares must be >= 0 "
                                "and rebalance_ratio > 1")
            if a.template is not None:
                self.instance_by_name(a.template)
        tnames = [t.name for t in self.tenants]
        if len(set(tnames)) != len(tnames):
            raise SpecError(f"fleet.tenants: duplicate tenant names "
                            f"{tnames}")
        for i, t in enumerate(self.tenants):
            if t.weight <= 0:
                raise SpecError(f"fleet.tenants[{i}].weight: must be > 0, "
                                f"got {t.weight}")


# -------------------------------------------------------------- SimSpec ----
@dataclass
class SimSpec:
    """One fully-described simulation experiment (see module docstring)."""
    model: ModelRef = field(default_factory=ModelRef)
    topology: TopologySpec = field(default_factory=TopologySpec)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    policy: PolicySpec = field(default_factory=PolicySpec)
    opmodel: OpModelSpec = field(default_factory=OpModelSpec)
    pipeline: Optional[PipelineSpec] = None
    memory: Optional[MemorySpec] = None
    slo: Optional[SLOSpec] = None
    faults: List[FaultSpec] = field(default_factory=list)
    fleet: Optional[FleetSpec] = None
    obs: Optional[ObsSpec] = None   # observability; None -> fully off
    seed: int = 0
    until: Optional[float] = None   # sim horizon (s); None -> completion
    name: str = ""

    def __post_init__(self) -> None:
        _coerce(self, int, "seed")
        _coerce(self, float, "until")

    # ---------------------------------------------------------- validate --
    def validate(self) -> "SimSpec":
        self.model.validate()
        self.topology.validate()
        self.workload.validate()
        self.policy.validate()
        self.opmodel.validate()
        if self.pipeline is not None:
            self.pipeline.validate()
        if self.memory is not None:
            self.memory.validate()
            if self.policy.memory is not None:
                raise SpecError(
                    "memory/policy.memory: both select a KV manager — use "
                    "the 'memory' section (policy.memory is the legacy "
                    "manager-only knob)")
            if self.memory.transfer_overlap > 0.0 \
                    and self.topology.fabric_config() is not None:
                raise SpecError(
                    "topology.fabric/memory.transfer_overlap: layer-"
                    "streamed KV transfer prices chunks against a "
                    "dedicated link and cannot be combined with shared-"
                    "fabric contention — set one of them to its default")
        if self.slo is not None:
            self.slo.validate()
        if self.obs is not None:
            self.obs.validate()
        if self.fleet is not None:
            self.fleet.validate(self.topology)
            if self.workload.arrival == "closed":
                raise SpecError(
                    "workload.arrival: closed-loop injection is per-"
                    "instance; fleet runs route open-loop arrivals through "
                    "the global router — use poisson/uniform/burst")
            if self.workload.turns > 1:
                raise SpecError(
                    "workload.turns: multi-turn conversations pin a growing "
                    "prefix to one instance's cache; fleet routing of "
                    "conversation turns is not modeled yet — use "
                    "prefix_groups for shared-prefix fleet workloads")
        names = self.topology.cluster_names()
        if self.fleet is not None:
            # the policy section is shared by EVERY instance, so a
            # cluster-keyed batching key must exist in every group's
            # topology (roles always resolve) — the intersection, not the
            # union, or one group's build would reject the key mid-run
            shared = None
            for inst in self.fleet.instances:
                cn = set((inst.topology or self.topology).cluster_names())
                shared = cn if shared is None else shared & cn
            names = sorted(shared or set())
        if self.policy._role_keyed():
            # role-keyed batching: a misspelled key would silently fall
            # back to the default policy, so reject unknown keys here
            # (where the topology's cluster names are known)
            bad = sorted(set(self.policy.batching)
                         - set(ROLES) - set(names))
            if bad:
                raise SpecError(
                    f"policy.batching: unknown role/cluster key(s) {bad}; "
                    f"roles: {sorted(ROLES)}, clusters: {names} (or give "
                    f"one policy for all clusters as {{'name': ...}})")
        for i, f in enumerate(self.faults):
            if self.fleet is not None:
                # the fault lands on ONE instance group (named, or the
                # first) — validate the cluster against THAT group's
                # topology, not the union, so a group/cluster mismatch
                # fails here and not mid-build
                group = self.fleet.instance_by_name(f.instance)
                f.validate((group.topology or self.topology)
                           .cluster_names(), f"faults[{i}]")
            else:
                if f.instance is not None:
                    raise SpecError(f"faults[{i}].instance: only fleet "
                                    f"specs have named instances")
                f.validate(names, f"faults[{i}]")
        if self.until is not None and self.until <= 0:
            raise SpecError(f"until: must be > 0 seconds, got {self.until}")
        return self

    # ------------------------------------------------------ serialization --
    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        # an unset calibration must hash/serialize exactly like specs that
        # predate the field, so spec hashes and goldens stay bit-identical
        if d.get("opmodel", {}).get("calibration") is None:
            d["opmodel"].pop("calibration", None)
        # same rule for the fabric/cost fields: unset must serialize like
        # specs that predate them
        topo = d.get("topology", {})
        for k in ("fabric", "dollars_per_hour"):
            if topo.get(k) is None:
                topo.pop(k, None)
        for inst in (d.get("fleet") or {}).get("instances") or []:
            it = inst.get("topology")
            if isinstance(it, dict):
                for k in ("fabric", "dollars_per_hour"):
                    if it.get(k) is None:
                        it.pop(k, None)
        # observability off must hash/serialize exactly like pre-obs specs
        if d.get("obs") is None:
            d.pop("obs", None)
        return d

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "SimSpec":
        if not isinstance(data, Mapping):
            raise SpecError(f"spec: expected a mapping, "
                            f"got {type(data).__name__}")
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise SpecError(f"spec: unknown field(s) {unknown}; "
                            f"known: {sorted(known)}")
        d = dict(data)
        spec = cls(
            model=_from_mapping(ModelRef, d.get("model"), "model")
            or ModelRef(),
            topology=_from_mapping(TopologySpec, d.get("topology"),
                                   "topology") or TopologySpec(),
            workload=_from_mapping(WorkloadSpec, d.get("workload"),
                                   "workload") or WorkloadSpec(),
            policy=_from_mapping(PolicySpec, d.get("policy"), "policy")
            or PolicySpec(),
            opmodel=_from_mapping(OpModelSpec, d.get("opmodel"), "opmodel")
            or OpModelSpec(),
            pipeline=(PipelineSpec(preset=d["pipeline"])
                      if isinstance(d.get("pipeline"), str) else
                      _from_mapping(PipelineSpec, d.get("pipeline"),
                                    "pipeline")),
            memory=(MemorySpec(manager=d["memory"])
                    if isinstance(d.get("memory"), str) else
                    _from_mapping(MemorySpec, d.get("memory"), "memory")),
            slo=_from_mapping(SLOSpec, d.get("slo"), "slo"),
            faults=[_from_mapping(FaultSpec, f, f"faults[{i}]")
                    for i, f in enumerate(d.get("faults") or [])],
            fleet=FleetSpec.parse(d.get("fleet")),
            obs=ObsSpec.parse(d.get("obs")),
            seed=int(d.get("seed", 0)),
            until=d.get("until"),
            name=d.get("name", ""))
        return spec

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SimSpec":
        return cls.from_dict(json.loads(text))

    def to_yaml(self) -> str:
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    @classmethod
    def from_yaml(cls, text: str) -> "SimSpec":
        import yaml
        data = yaml.safe_load(text)
        if data is None:
            raise SpecError("spec: empty YAML document")
        return cls.from_dict(data)

    @classmethod
    def load(cls, path: str) -> "SimSpec":
        """Load a spec from a .yaml/.yml/.json file."""
        with open(path) as f:
            text = f.read()
        if str(path).endswith(".json"):
            return cls.from_json(text)
        return cls.from_yaml(text)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() if str(path).endswith(".json")
                    else self.to_yaml())

    # ----------------------------------------------------------- identity --
    def spec_hash(self) -> str:
        """Deterministic 16-hex-digit digest of the canonical spec dict."""
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"), default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def with_(self, **updates: Any) -> "SimSpec":
        """Copy with dotted-path updates, e.g. ``with_(**{"workload.rate":
        8.0, "seed": 3})`` — the mechanism sweeps use for axis points."""
        d = self.to_dict()
        for key, value in updates.items():
            set_path(d, key, value)
        return SimSpec.from_dict(d)


def set_path(d: Dict[str, Any], path: str, value: Any) -> None:
    """Set a dotted path in a nested spec dict, with shorthand resolution:
    a bare field name (``tp``) is searched in the spec root, then in
    topology / workload / policy."""
    parts = path.split(".")
    if len(parts) == 1 and parts[0] not in d \
            and parts[0] not in {f.name for f in fields(SimSpec)}:
        # (a real SimSpec field absent from the dict is an UNSET optional
        # section — to_dict strips those — so it is still a top-level set)
        for section in ("topology", "workload", "policy", "pipeline",
                        "memory", "fleet", "obs"):
            sub = d.get(section)
            if isinstance(sub, Mapping) and parts[0] in sub:
                parts = [section, parts[0]]
                break
        else:
            raise SpecError(
                f"axis/path {path!r}: not a spec field and not found in "
                f"topology/workload/policy; use a dotted path like "
                f"'workload.rate'")
    cur: Any = d
    for p in parts[:-1]:
        if not isinstance(cur, dict):
            raise SpecError(f"axis/path {path!r}: {p!r} is not a mapping")
        if not isinstance(cur.get(p), dict):
            if cur.get(p) is not None:
                raise SpecError(
                    f"axis/path {path!r}: {p!r} holds "
                    f"{cur[p]!r}, not a mapping — replace the whole "
                    f"field instead")
            cur[p] = {}     # e.g. slo: None -> slo.ttft_s=... creates it
        cur = cur[p]
    if not isinstance(cur, dict):
        raise SpecError(f"axis/path {path!r}: parent is not a mapping")
    cur[parts[-1]] = value
