"""``run(spec) -> Report``: execute one SimSpec and return a typed report.

The Report replaces the raw metrics dict: summary percentiles (TTFT/TPOT/
e2e/queueing/goodput), per-cluster breakdowns (utilization, replica stats,
AF expert-parallel totals incl. straggler excess and cross-cluster bytes),
the request-conservation check, and provenance (spec hash, wall clock,
event count) — everything a sweep point needs to be self-describing on
disk.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from datetime import datetime, timezone
from typing import Any, Dict, Mapping, Optional

from repro_torch.api.spec import SimSpec, SpecError, _resolve_hw
from repro_torch.configs import get_config
from repro_torch.core.hardware import HardwareSpec, LinkSpec, ParallelismConfig
from repro_torch.core.opmodels import resolve_opmodels
from repro_torch.core.policies.batching import resolve_batching
from repro_torch.core.topology import SystemHandle, build_system
from repro_torch.core.workflows.af_disagg import build_af
from repro_torch.core.workflows.colocated import build_colocated
from repro_torch.core.workflows.pd_disagg import build_pd


class ReportBase:
    """Shared serialization surface of Report and FleetReport: summary
    item access, dict/JSON round-trip, and file save — one implementation
    so the two report types cannot drift apart."""

    def __getitem__(self, key: str) -> float:
        return self.summary[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.summary.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]):
        return cls(**dict(d))

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=float)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))
            f.write("\n")


@dataclass
class Report(ReportBase):
    """Typed result of one simulation run (JSON-serializable)."""
    name: str
    spec: Dict[str, Any]
    spec_hash: str
    summary: Dict[str, float]
    clusters: Dict[str, Dict[str, Any]]
    conservation: Dict[str, int]
    all_complete: bool
    n_devices: int
    sim_events: int
    sim_duration_s: float
    wall_clock_s: float
    created_at: str
    point: Optional[Dict[str, Any]] = None   # sweep-axis assignment


# ----------------------------------------------------------------- build --
def build(spec: SimSpec, *,
          hardware: Optional[HardwareSpec] = None,
          ops=None,
          engine=None,
          device="cuda") -> SystemHandle:
    """Compile a validated SimSpec into a runnable SystemHandle.

    ``hardware``/``ops`` inject measured/calibrated objects (the
    benchmark-calibration flow); by default both come from the spec.
    ``engine`` injects a shared SimEngine — how the fleet layer builds
    many instances into ONE deterministic event timeline.  ``device`` is
    handed to every replica's predictor: where ``backend: jit`` evaluates
    its fused roofline (the card unless ``"cpu"`` is asked for; without
    a card it raises).  The python and numpy backends never read it.
    """
    if spec.fleet is not None:
        raise SpecError(
            "spec.fleet: build() compiles ONE deployment — fleet specs go "
            "through run() (repro_torch.fleet.run_fleet), which builds each "
            "instance from a fleet-stripped sub-spec")
    spec.validate()
    cfg = get_config(spec.model.name, smoke=spec.model.smoke)
    topo = spec.topology
    hw = hardware if hardware is not None \
        else _resolve_hw(topo.hardware, "topology.hardware")
    if ops is None:
        if spec.opmodel.calibration is not None:
            from repro_torch.calib import CalibrationError, load_calibrated_ops
            try:
                ops = load_calibrated_ops(spec.opmodel.calibration, cfg, hw)
            except CalibrationError as e:
                raise SpecError(f"opmodel.calibration: {e}") from e
        else:
            ops = resolve_opmodels(spec.opmodel.name, hw)
    pol = spec.policy
    pipeline = spec.pipeline.to_config() if spec.pipeline is not None \
        else None
    common = dict(ops=ops, routing=pol.router, seed=spec.seed,
                  engine=engine,
                  memory=pol.memory, queue_policy=pol.scheduler,
                  memoize=topo.memoize, pipeline=pipeline,
                  fabric=topo.fabric_config())
    if spec.memory is not None:
        # no memory section -> omit the kwargs so build_system's own
        # defaults apply (one source of truth for the legacy values)
        common.update(memory=spec.memory.manager_mapping(),
                      transfer_overlap=spec.memory.transfer_overlap,
                      kv_frac=spec.memory.capacity_frac)

    def batching(role: str, name: str = ""):
        try:
            return resolve_batching(pol.batching_for(role, name))
        except (KeyError, TypeError) as e:
            raise SpecError(f"policy.batching: {e}") from e

    if topo.preset == "colocated":
        handle = build_colocated(
            cfg, hw, n_replicas=topo.n_replicas,
            par=ParallelismConfig(tp=topo.tp, pp=topo.pp, ep=topo.ep),
            policy=batching("colocated", "colocated"), **common)
    elif topo.preset == "pd":
        handle = build_pd(
            cfg, hw, n_prefill=topo.n_prefill, n_decode=topo.n_decode,
            prefill_par=ParallelismConfig(tp=topo.prefill_tp),
            decode_par=ParallelismConfig(tp=topo.decode_tp),
            prefill_policy=batching("prefill", "prefill"),
            decode_policy=batching("decode", "decode"),
            transfer_bw=topo.transfer_bw, **common)
    elif topo.preset == "af":
        common.pop("memoize")
        link = None
        if topo.expert_link_bw is not None:
            link = LinkSpec("decode", "decode-experts",
                            bandwidth=topo.expert_link_bw,
                            latency=topo.expert_link_latency)
        handle = build_af(
            cfg, hw, n_prefill=topo.n_prefill, n_decode=topo.n_decode,
            m=topo.m, attn_par=ParallelismConfig(tp=topo.attn_tp),
            ffn_par=ParallelismConfig(tp=topo.ffn_tp, ep=topo.ffn_ep),
            prefill_par=ParallelismConfig(tp=topo.prefill_tp),
            remote_expert_ranks=tuple(topo.remote_expert_ranks),
            expert_cluster_hw=(_resolve_hw(topo.expert_cluster_hw,
                                           "topology.expert_cluster_hw")
                               if topo.expert_cluster_hw else None),
            expert_link=link, memoize=topo.memoize, **common)
    else:
        # inline StageGraph (the graph itself carries the fabric config)
        graph = topo.inline_graph(batching=lambda role, name:
                                  pol.batching_for(role, name))
        handle = build_system(cfg, hw, graph, transfer_bw=topo.transfer_bw,
                              **{k: v for k, v in common.items()
                                 if k not in ("memoize", "fabric")})
    if topo.dollars_per_hour:
        # spec-level $/GPU-hr overrides reprice each cluster's hardware;
        # downstream cost accounting reads cluster.hw
        for cluster in handle.clusters.values():
            cluster.hw = topo.hw_pricing(cluster.hw)
    for cluster in handle.clusters.values():
        for w in cluster.replicas:
            w.predictor.device = device
            if spec.opmodel.backend != "python":
                w.predictor.backend = spec.opmodel.backend
    return handle


def _apply_faults(spec: SimSpec, handle: SystemHandle) -> None:
    for i, f in enumerate(spec.faults):
        cluster = handle.clusters[f.cluster]
        if f.replica >= len(cluster.replicas):
            raise SpecError(
                f"faults[{i}].replica: index {f.replica} out of range — "
                f"cluster {f.cluster!r} has {len(cluster.replicas)} "
                f"replicas")
        if f.kind == "failure":
            handle.controller.inject_failure(f.cluster, f.replica,
                                             at=f.at, downtime=f.downtime)
        else:   # straggler
            cluster.replicas[f.replica].slowdown = f.slowdown


def _cluster_breakdown(handle: SystemHandle) -> Dict[str, Dict[str, Any]]:
    now = handle.engine.now
    out: Dict[str, Dict[str, Any]] = {}
    for name, cluster in handle.clusters.items():
        cspec = getattr(cluster, "spec", None)
        info: Dict[str, Any] = {
            "role": cluster.role,
            "n_replicas": len(cluster.replicas),
            "devices": (cspec.n_replicas * cspec.devices_per_replica()
                        if cspec is not None else len(cluster.replicas)),
            "hardware": getattr(getattr(cluster, "hw", None), "name", None),
            "utilization": cluster.utilization(now),
            "replicas": {w.name: dict(w.stats) for w in cluster.replicas},
        }
        # provisioning cost: the cluster's device-count x $/GPU-hr rate
        # (run()/run_fleet fill in the time-integrated $ figures)
        info["cost"] = {
            "dollars_per_hour": info["devices"] * getattr(
                getattr(cluster, "hw", None), "dollars_per_hour", 0.0),
        }
        # memory-subsystem observability: per-cluster KV manager aggregates
        mems = [w.memory for w in cluster.replicas if w.memory is not None]
        if mems:
            hit = sum(m.hit_tokens for m in mems)
            prompt = sum(m.prompt_tokens for m in mems)
            info["memory"] = {
                "manager": type(mems[0]).name,
                "total_blocks": sum(m.total_blocks for m in mems),
                "utilization": (sum(m.utilization for m in mems)
                                / len(mems)),
                "peak_utilization": max(m.peak_utilization for m in mems),
                "cached_blocks": sum(m.cached_blocks() for m in mems),
                "preemptions": sum(w.stats.get("preemptions", 0)
                                   for w in cluster.replicas),
                "swap_outs": sum(w.stats.get("swap_outs", 0)
                                 for w in cluster.replicas),
                "swap_ins": sum(w.stats.get("swap_ins", 0)
                                for w in cluster.replicas),
                "evictions": sum(m.evictions for m in mems),
                "evicted_blocks": sum(m.evicted_blocks for m in mems),
                "prefix_hit_tokens": hit,
                "prefix_prompt_tokens": prompt,
                "prefix_hit_rate": (hit / prompt) if prompt else None,
            }
        # AF expert-parallel observability: aggregate per-replica totals
        af: Dict[str, float] = {}
        for w in cluster.replicas:
            totals = getattr(w.predictor, "af_totals", None)
            if totals:
                for k, v in totals.items():
                    af[k] = af.get(k, 0) + v
        if af:
            makespan = af.get("makespan_s", 0.0)
            serial = af.get("serial_makespan_s", 0.0)
            # latency-hiding derived observables: how much of the serial
            # chain was hidden, and the comm time each stage had exposed
            if serial > 0:
                af["overlap_efficiency"] = max(1.0 - makespan / serial, 0.0)
            if makespan > 0:
                af["attn_exposed_comm_frac"] = \
                    af.get("attn_exposed_comm_s", 0.0) / makespan
                af["ffn_exposed_comm_frac"] = \
                    af.get("ffn_exposed_comm_s", 0.0) / makespan
            info["af"] = af
        out[name] = info
    return out


def predictor_cache_stats(handle: SystemHandle) -> Dict[str, Any]:
    """Memo-cache effectiveness across every replica predictor: how much
    simulated work the shape-bucketed step cache absorbed (the dominant
    hot-path shortcut, so a collapsed hit rate explains a slow run)."""
    hits = misses = 0
    for cluster in handle.clusters.values():
        for w in cluster.replicas:
            hits += w.predictor.cache_hits
            misses += w.predictor.cache_misses
    total = hits + misses
    return {
        "predictor_cache_hits": hits,
        "predictor_cache_misses": misses,
        "predictor_cache_hit_rate": (hits / total) if total else None,
    }


# ------------------------------------------------------------------- run --
def run(spec: SimSpec, *,
        hardware: Optional[HardwareSpec] = None,
        ops=None,
        engine_overhead: Optional[float] = None,
        telemetry=None,
        device="cuda") -> Report:
    """Validate, build, and run one experiment; return its Report.

    Same spec + same seed is bit-deterministic: the event engine orders
    simultaneous events by schedule sequence and every RNG is seeded from
    ``spec.seed``.

    A spec with a ``fleet`` section dispatches to the fleet control plane
    and returns a :class:`repro_torch.fleet.FleetReport` (same surface:
    ``summary`` / ``spec_hash`` / ``save`` / item access).

    ``telemetry`` injects an externally owned :class:`repro_torch.obs.Telemetry`
    recorder (how ``run_traced`` keeps the spans after the run); with the
    default ``None``, a recorder is created internally iff ``spec.obs``
    is enabled.  Obs-off runs never touch the recorder paths.  ``device``
    is handed to :func:`build` (through the fleet layer for a fleet spec).
    """
    if spec.fleet is not None:
        from repro_torch.fleet import run_fleet
        return run_fleet(spec, hardware=hardware, ops=ops,
                         engine_overhead=engine_overhead,
                         telemetry=telemetry, device=device)
    if telemetry is None and spec.obs is not None and spec.obs.enabled:
        from repro_torch.obs import Telemetry
        telemetry = Telemetry.from_spec(spec.obs)
    t0 = time.perf_counter()
    handle = build(spec, hardware=hardware, ops=ops, device=device)
    if telemetry is not None:
        from repro_torch.obs import attach_telemetry
        attach_telemetry(handle, telemetry)
    if engine_overhead is not None:
        for cluster in handle.clusters.values():
            for w in cluster.replicas:
                w.predictor.engine_overhead = engine_overhead
    _apply_faults(spec, handle)
    requests = spec.workload.build_requests(spec.seed)
    closed = (spec.workload.concurrency
              if spec.workload.arrival == "closed" else None)
    summary = handle.run(
        requests,
        until=spec.until if spec.until is not None else float("inf"),
        closed_concurrency=closed,
        slo_ttft=spec.slo.ttft_s if spec.slo else None,
        slo_tpot=spec.slo.tpot_s if spec.slo else None)
    wall = time.perf_counter() - t0
    conservation = handle.controller.conservation_check()
    clusters = _cluster_breakdown(handle)
    # lift aggregate latency-hiding observables into the summary (AF
    # event-graph clusters book both actual and serial makespans)
    makespan = sum(c["af"].get("makespan_s", 0.0)
                   for c in clusters.values() if "af" in c)
    serial = sum(c["af"].get("serial_makespan_s", 0.0)
                 for c in clusters.values() if "af" in c)
    if serial > 0:
        summary["bubble_time_s"] = sum(c["af"].get("bubble_time_s", 0.0)
                                       for c in clusters.values()
                                       if "af" in c)
        summary["overlap_efficiency"] = max(1.0 - makespan / serial, 0.0)
    # memory-subsystem observables: prefix-cache hits and exposed vs
    # lump-sum KV-transfer time (PD layer-wise streaming); "preemptions"
    # is already in the summary via SystemHandle.run
    prompt_toks = sum(c["memory"]["prefix_prompt_tokens"]
                      for c in clusters.values() if "memory" in c)
    if prompt_toks:
        hit_toks = sum(c["memory"]["prefix_hit_tokens"]
                       for c in clusters.values() if "memory" in c)
        summary["prefix_hit_token_frac"] = hit_toks / prompt_toks
    summary.update(predictor_cache_stats(handle))
    ts = handle.controller.transfer_stats
    if ts["transfers"]:
        summary["kv_transfer_count"] = ts["transfers"]
        summary["kv_transfer_serial_s"] = ts["serial_s"]
        summary["kv_transfer_exposed_s"] = ts["exposed_s"]
        summary["kv_transfer_exposed_frac"] = (
            ts["exposed_s"] / ts["serial_s"] if ts["serial_s"] > 0 else 1.0)
    # first-class $ accounting: provisioned rate from each cluster's
    # hardware pricing, integrated over the measured duration
    duration = float(summary.get("duration_s") or 0.0)
    rate = 0.0
    for c in clusters.values():
        crate = c["cost"]["dollars_per_hour"]
        c["cost"]["provisioned_dollars"] = crate * duration / 3600.0
        toks = sum(r.get("tokens", 0) for r in c["replicas"].values())
        c["cost"]["tok_per_s_per_dollar"] = (
            float(toks / duration / crate) if crate > 0 and duration > 0
            else None)
        rate += crate
    summary["dollars_per_hour"] = rate
    summary["provisioned_dollars"] = rate * duration / 3600.0
    tput = float(summary.get("throughput_tok_s") or 0.0)
    summary["tok_per_s_per_dollar"] = tput / rate if rate > 0 else None
    if handle.fabric is not None:
        fs = handle.fabric.stats
        exposed = handle.fabric.exposed_comm_s()
        uncontended = handle.fabric.uncontended_comm_s()
        summary["fabric_transfers"] = fs["transfers"]
        summary["fabric_exposed_comm_s"] = exposed
        summary["fabric_uncontended_comm_s"] = uncontended
        summary["fabric_contention_delay_s"] = exposed - uncontended
    if telemetry is not None:
        summary.update(telemetry.summary_fields())
    return Report(
        name=spec.name,
        spec=spec.to_dict(),
        spec_hash=spec.spec_hash(),
        summary=summary,
        clusters=clusters,
        conservation=conservation,
        all_complete=(conservation == {"complete": len(requests)}),
        n_devices=handle.n_devices,
        sim_events=handle.engine.processed,
        sim_duration_s=summary.get("duration_s", 0.0),
        wall_clock_s=wall,
        created_at=datetime.now(timezone.utc).isoformat(timespec="seconds"),
    )
