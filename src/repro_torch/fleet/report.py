"""``run_fleet(spec) -> FleetReport``: execute a fleet SimSpec.

The FleetReport aggregates per-instance Reports (summary + cluster
breakdown per instance) under fleet-level metrics: per-tenant SLO
attainment, routing imbalance, the scale-event log, and provisioned-but-
idle GPU-seconds.  Its surface mirrors :class:`repro_torch.api.run.Report`
(``summary`` / ``spec_hash`` / ``save`` / item access), so the CLI, sweep
runner, and pareto helpers work on fleets unchanged.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from repro_torch.api.run import ReportBase
from repro_torch.core.engine import SimEngine
from repro_torch.core.metrics import MetricsCollector, _mean, _pct, slo_attainment
from repro_torch.fleet.controller import FleetController
from repro_torch.fleet.instance import Instance


@dataclass
class FleetReport(ReportBase):
    """Typed result of one fleet simulation (JSON-serializable; shares
    Report's serialization surface via :class:`ReportBase`)."""
    name: str
    spec: Dict[str, Any]
    spec_hash: str
    summary: Dict[str, Any]
    instances: Dict[str, Dict[str, Any]]     # per-instance sub-reports
    tenants: Dict[str, Dict[str, Any]]       # per-tenant-class metrics
    scale_events: List[Dict[str, Any]]
    conservation: Dict[str, int]
    all_complete: bool
    n_devices: int                            # peak provisioned devices
    sim_events: int
    sim_duration_s: float
    wall_clock_s: float
    created_at: str
    point: Optional[Dict[str, Any]] = None    # sweep-axis assignment


# ------------------------------------------------------------- assembly --
def _instance_block(inst: Instance, spec) -> Dict[str, Any]:
    from repro_torch.api.run import _cluster_breakdown
    ctrl = inst.controller
    # per-device stats use the instance's PEAK PROVISIONED devices (the
    # same basis as the fleet summary) — handle.n_devices would count
    # parked P:D standby replicas that never held GPUs
    summary = ctrl.metrics.report(
        n_devices=inst.peak_devices or inst.handle.n_devices,
        slo_ttft=spec.slo.ttft_s if spec.slo else None,
        slo_tpot=spec.slo.tpot_s if spec.slo else None)
    return {
        "group": inst.group.name,
        "state": inst.state,
        "devices": inst.peak_devices,
        "created_at_s": inst.created_at,
        "active_at_s": inst.active_at,
        "stopped_at_s": inst.stopped_at,
        "routed": inst.routed,
        "outstanding": inst.outstanding(),
        "gpu_seconds": inst.gpu_seconds,
        "busy_gpu_seconds": inst.busy_gpu_seconds(),
        "provisioned_dollars": inst.provisioned_dollars,
        "dollars_per_hour": inst.dollar_rate(),
        "summary": summary,
        "clusters": _cluster_breakdown(inst.handle),
        "conservation": ctrl.conservation_check(),
    }


def _tenant_block(spec, completed) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for t in spec.fleet.tenants:
        mine = [r for r in completed if r.tenant == t.name]
        ttfts = [r.ttft() for r in mine if r.ttft() is not None]
        ttft = t.ttft_s if t.ttft_s is not None \
            else (spec.slo.ttft_s if spec.slo else None)
        tpot = t.tpot_s if t.tpot_s is not None \
            else (spec.slo.tpot_s if spec.slo else None)
        out[t.name] = {
            "n_completed": len(mine),
            "priority": t.priority,
            "ttft_p50_s": _pct(ttfts, 50),
            "ttft_p99_s": _pct(ttfts, 99),
            "ttft_mean_s": _mean(ttfts),
            "slo_ttft_s": ttft,
            "slo_tpot_s": tpot,
            "slo_attainment": slo_attainment(mine, ttft_s=ttft,
                                             tpot_s=tpot),
        }
    return out


def _routing_imbalance(instances: Dict[str, Instance]) -> Optional[float]:
    """Coefficient of variation of per-instance routed-request counts —
    0 means perfectly even; grows with hot-spotting."""
    counts = [i.routed for i in instances.values()]
    if not counts or sum(counts) == 0:
        return None
    mean = sum(counts) / len(counts)
    var = sum((c - mean) ** 2 for c in counts) / len(counts)
    return (var ** 0.5) / mean


# ------------------------------------------------------------------ run --
def run_fleet(spec, *, hardware=None, ops=None,
              engine_overhead=None, telemetry=None,
              device="cuda") -> FleetReport:
    """Validate, build, and run one fleet experiment (see module doc).

    ``telemetry`` injects a shared :class:`repro_torch.obs.Telemetry` recorder
    spanning every instance (windowed sub-engines keep absolute sim time,
    so all spans merge on the global clock); ``None`` creates one iff
    ``spec.obs`` is enabled.  ``device`` is handed to every instance's
    :func:`repro_torch.api.run.build`."""
    t0 = time.perf_counter()
    spec.validate()
    if telemetry is None and spec.obs is not None and spec.obs.enabled:
        from repro_torch.obs import Telemetry
        telemetry = Telemetry.from_spec(spec.obs)
    engine = SimEngine()
    fc = FleetController(spec, engine, hardware=hardware, ops=ops,
                         engine_overhead=engine_overhead,
                         telemetry=telemetry, device=device)
    requests = spec.workload.build_requests(spec.seed)
    fc.submit_all(requests)
    until = spec.until if spec.until is not None else float("inf")
    if fc.windowed:
        from repro_torch.fleet.windowed import run_windowed
        run_windowed(fc, until, spec.fleet.window_s)
    else:
        engine.run(until)
    fc.finalize()
    wall = time.perf_counter() - t0

    insts = fc.instances
    merged = MetricsCollector.merged(
        [i.controller.metrics for i in insts.values()])
    summary = merged.report(
        n_devices=fc.peak_devices,
        slo_ttft=spec.slo.ttft_s if spec.slo else None,
        slo_tpot=spec.slo.tpot_s if spec.slo else None)
    # fleet-level observables
    kinds = [e["kind"] for e in fc.scale_events]
    gpu_s = sum(i.gpu_seconds for i in insts.values())
    busy_s = sum(i.busy_gpu_seconds() for i in insts.values())
    # fleet $ accounting: each instance integrates its own provisioned-$
    # (heterogeneous hardware prices per cluster), so fleet $ == sum of
    # instance $ by construction — a property test pins this identity
    dollars = sum(i.provisioned_dollars for i in insts.values())
    idle_frac = max(gpu_s - busy_s, 0.0) / gpu_s if gpu_s > 0 else 0.0
    duration = float(summary.get("duration_s") or 0.0)
    tput = float(summary.get("throughput_tok_s") or 0.0)
    summary.update({
        "fleet_instances_built": len(insts),
        "fleet_instances_active_end": sum(
            1 for i in insts.values() if i.routable),
        "scale_up_events": kinds.count("scale_up"),
        "scale_down_events": kinds.count("scale_down"),
        "rebalance_events": kinds.count("rebalance"),
        "routing_imbalance": _routing_imbalance(insts),
        "provisioned_gpu_seconds": gpu_s,
        "idle_gpu_seconds": max(gpu_s - busy_s, 0.0),
        "provisioned_dollars": dollars,
        # $ paid for capacity that sat idle (idle-GPU-fraction of spend)
        "idle_dollars": dollars * idle_frac,
        # time-averaged fleet burn rate over the measured window
        "dollars_per_hour": (dollars / (duration / 3600.0)
                             if duration > 0 else 0.0),
        "tok_per_s_per_dollar": (
            tput / (dollars / (duration / 3600.0))
            if duration > 0 and dollars > 0 else None),
    })
    summary["fleet_engine_mode"] = spec.fleet.engine
    if spec.fleet.engine == "windowed":
        summary["fleet_window_s"] = spec.fleet.window_s
    # fleet prefix-cache hit rate (the prize cache-aware routing chases)
    # + predictor memo-cache effectiveness pooled across every replica
    hit = prompt = 0
    cache_hits = cache_misses = 0
    transfers: Dict[str, float] = {}
    for inst in insts.values():
        for cluster in inst.handle.clusters.values():
            for w in cluster.replicas:
                cache_hits += w.predictor.cache_hits
                cache_misses += w.predictor.cache_misses
                if w.memory is not None:
                    hit += w.memory.hit_tokens
                    prompt += w.memory.prompt_tokens
        ts = inst.controller.transfer_stats
        for k, v in ts.items():
            transfers[k] = transfers.get(k, 0.0) + v
    total_lookups = cache_hits + cache_misses
    summary["predictor_cache_hits"] = cache_hits
    summary["predictor_cache_misses"] = cache_misses
    summary["predictor_cache_hit_rate"] = \
        (cache_hits / total_lookups) if total_lookups else None
    if prompt:
        summary["prefix_hit_token_frac"] = hit / prompt
    if transfers.get("transfers"):
        summary["kv_transfer_count"] = transfers["transfers"]
        summary["kv_transfer_serial_s"] = transfers["serial_s"]
        summary["kv_transfer_exposed_s"] = transfers["exposed_s"]
    # shared-fabric contention, pooled across instances that model one
    fabrics = [i.handle.fabric for i in insts.values()
               if getattr(i.handle, "fabric", None) is not None]
    if fabrics:
        exposed = sum(f.exposed_comm_s() for f in fabrics)
        uncontended = sum(f.uncontended_comm_s() for f in fabrics)
        summary["fabric_transfers"] = sum(f.stats["transfers"]
                                          for f in fabrics)
        summary["fabric_exposed_comm_s"] = exposed
        summary["fabric_uncontended_comm_s"] = uncontended
        summary["fabric_contention_delay_s"] = exposed - uncontended
    tenants = _tenant_block(spec, merged.completed)
    attains = [t["slo_attainment"] for t in tenants.values()
               if t["slo_attainment"] is not None]
    if attains:
        summary["tenant_slo_attainment_min"] = min(attains)
    if telemetry is not None:
        summary.update(telemetry.summary_fields())
    conservation = fc.conservation_check()
    return FleetReport(
        name=spec.name,
        spec=spec.to_dict(),
        spec_hash=spec.spec_hash(),
        summary=summary,
        instances={n: _instance_block(i, spec) for n, i in insts.items()},
        tenants=tenants,
        scale_events=fc.scale_events,
        conservation=conservation,
        all_complete=(conservation == {"complete": len(requests)}),
        n_devices=fc.peak_devices,
        # windowed mode: the fleet engine plus every distinct sub-engine
        sim_events=sum(e.processed for e in
                       {id(engine): engine,
                        **{id(i.handle.engine): i.handle.engine
                           for i in insts.values()}}.values()),
        sim_duration_s=summary.get("duration_s", 0.0),
        wall_clock_s=wall,
        created_at=datetime.now(timezone.utc).isoformat(timespec="seconds"),
    )
