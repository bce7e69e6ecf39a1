"""The telemetry recorder and its attachment seam.

One :class:`Telemetry` instance records an entire run — for fleets it is
shared by every instance's sub-engine (windowed sub-engines keep
absolute sim time, so spans from all instances merge on the global clock
with no translation).  Core components (``ReplicaWorker``,
``GlobalController``, ``Fabric``, ``FleetController``) each carry a
``telemetry`` attribute that defaults to ``None``; every instrumentation
site guards on it, so runs without observability execute the exact
pre-observability code path.

:func:`attach_telemetry` is the one wiring point: given a built
``SystemHandle`` it registers replica identity (cluster + instance),
sets the ``telemetry`` attributes, and — when EP spans are requested —
arms ``AFPipelinePredictor.af_trace`` so the per-EP-rank marker events
of cache-miss decode steps are recorded (the traced inner engine is
bit-identical to the fast virtual path; cache-hit steps replay memoized
results and carry no markers).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.events import EV
from repro_torch.obs.attribution import (
    ATTRIBUTION_KEYS, aggregate_fractions, attribution_for,
)
from repro_torch.obs.counters import CounterBoard
from repro_torch.obs.spans import Span


@dataclass
class RequestRecord:
    """Per-request outcome: identity, latency, and its attribution."""
    rid: int
    arrival: float
    finish: float
    e2e: float
    ttft: Optional[float]
    instance: str = ""
    tenant: Optional[str] = None
    attribution: Dict[str, float] = field(default_factory=dict)
    n_spans: int = 0

    def to_dict(self) -> dict:
        return {"rid": self.rid, "arrival": self.arrival,
                "finish": self.finish, "e2e": self.e2e, "ttft": self.ttft,
                "instance": self.instance, "tenant": self.tenant,
                "attribution": dict(self.attribution),
                "n_spans": self.n_spans}


class Telemetry:
    """Span + counter recorder for one run (single-instance or fleet)."""

    def __init__(self, *, spans: bool = True, counters: bool = True,
                 ep_spans: bool = False, max_spans: int = 500_000,
                 max_counter_points: int = 4096):
        self.spans_enabled = spans
        self.counters_enabled = counters
        self.ep_spans = ep_spans
        self.max_spans = int(max_spans)
        self.spans: List[Span] = []
        self.dropped_spans = 0
        self.counters = CounterBoard(max_counter_points)
        self.records: List[RequestRecord] = []
        # replica name -> (cluster, instance) identity for export
        self._replicas: Dict[str, Tuple[str, str]] = {}
        # open coalesced decode spans keyed by (rid, replica)
        self._open_decode: Dict[Tuple[int, str], Span] = {}
        # per-request span index, dropped after the request finishes
        self._by_rid: Dict[int, List[Span]] = {}
        # AF inner-engine recording state (set per batch by the replica)
        self._af_base = 0.0
        self._af_replica = ""
        self._af_pending: Dict[Tuple[int, int, int], float] = {}

    @classmethod
    def from_spec(cls, obs) -> "Telemetry":
        """Build from an :class:`repro_torch.api.spec.ObsSpec`."""
        return cls(spans=obs.spans, counters=obs.counters,
                   ep_spans=obs.ep_spans, max_spans=obs.max_spans,
                   max_counter_points=obs.max_counter_points)

    # ---- identity registry -------------------------------------------------

    def register_replica(self, replica: str, *, cluster: str = "",
                         instance: str = "") -> None:
        self._replicas[replica] = (cluster, instance)

    def replica_info(self, replica: str) -> Tuple[str, str]:
        return self._replicas.get(replica, ("", ""))

    # ---- spans -------------------------------------------------------------

    def span(self, kind: str, rid: int, start: float, end: float, *,
             replica: str = "", **meta) -> None:
        if not self.spans_enabled:
            return
        if len(self.spans) >= self.max_spans:
            self.dropped_spans += 1
            return
        s = Span(kind, rid, start, end, replica, meta)
        self.spans.append(s)
        if rid >= 0:
            self._by_rid.setdefault(rid, []).append(s)

    def compute_span(self, kind: str, rid: int, start: float, end: float,
                     replica: str, **meta) -> None:
        """Record a compute interval; contiguous decode epochs on the
        same replica coalesce into one growing span (continuous batching
        emits one batch per token — thousands of 1-token spans per
        request would swamp both memory and the trace viewer)."""
        if not self.spans_enabled:
            return
        if kind == "decode":
            key = (rid, replica)
            open_ = self._open_decode.get(key)
            if open_ is not None:
                if start <= open_.end + 1e-12:
                    open_.end = end
                    open_.meta["epochs"] = open_.meta.get("epochs", 1) + 1
                    return
                self._flush_decode(key)
            if len(self.spans) >= self.max_spans:
                self.dropped_spans += 1
                return
            s = Span(kind, rid, start, end, replica, dict(meta, epochs=1))
            self._open_decode[key] = s
            self.spans.append(s)
            if rid >= 0:
                self._by_rid.setdefault(rid, []).append(s)
            return
        self.span(kind, rid, start, end, replica=replica, **meta)

    def _flush_decode(self, key) -> None:
        self._open_decode.pop(key, None)

    # ---- counters ----------------------------------------------------------

    def counter(self, name: str, t: float, value: float, *,
                replica: str = "", instance: str = "") -> None:
        if not self.counters_enabled:
            return
        if not instance and replica:
            instance = self._replicas.get(replica, ("", ""))[1]
        if instance:
            # replica names repeat across fleet instances (every pd
            # instance has a "prefill0") — namespace per-instance series
            # so they never merge
            name = f"{instance}/{name}"
        self.counters.sample(name, t, value, replica=replica,
                             instance=instance)

    # ---- AF inner-engine (per-EP-rank) recording ---------------------------

    def begin_batch(self, replica: str, now: float) -> None:
        """Anchor for inner-engine AF traces: events of the traced decode
        step are step-relative, so the recorder adds the batch start."""
        self._af_base = now
        self._af_replica = replica
        self._af_pending.clear()

    def af_event(self, ev) -> None:
        """``AFPipelinePredictor.af_trace`` callback (cache-miss decode
        steps only — cache hits replay memoized stats with no markers)."""
        kind = ev.kind
        if kind is EV.EXPERT_DISPATCH_DONE:
            d = ev.data
            key = (d["i"], d["k"], d["r"])
            self._af_pending[key] = ev.time
            self.span("ep_dispatch", -1, self._af_base + ev.time,
                      self._af_base + ev.time, replica=self._af_replica,
                      rank=d["r"], layer=d["k"], micro=d["i"])
        elif kind is EV.EXPERT_RANK_DONE:
            d = ev.data
            t0 = self._af_pending.pop((d["i"], d["k"], d["r"]), ev.time)
            self.span("ep_rank", -1, self._af_base + t0,
                      self._af_base + ev.time, replica=self._af_replica,
                      rank=d["r"], layer=d["k"], micro=d["i"])
        elif kind is EV.EXPERT_COMBINE_DONE:
            d = ev.data
            self.span("ep_combine", -1, self._af_base + ev.time,
                      self._af_base + ev.time, replica=self._af_replica,
                      layer=d["k"], micro=d["i"])

    # ---- request lifecycle -------------------------------------------------

    def end_request(self, r, *, instance: str = "") -> None:
        """Close out one finished request: emit its queue-wait span,
        flush any open decode span, and derive latency attribution."""
        rid = r.rid
        for key in [k for k in self._open_decode if k[0] == rid]:
            self._flush_decode(key)
        first = r.timestamps.get("first_scheduled")
        if first is not None and first > r.arrival:
            self.span("queue_wait", rid, r.arrival, first,
                      instance=instance)
        finish = r.finish_time if r.finish_time is not None else r.arrival
        spans = self._by_rid.pop(rid, ())
        attr = attribution_for(spans, r.arrival, finish)
        ttft = r.ttft() if callable(getattr(r, "ttft", None)) else None
        self.records.append(RequestRecord(
            rid=rid, arrival=r.arrival, finish=finish,
            e2e=max(finish - r.arrival, 0.0), ttft=ttft,
            instance=instance, tenant=getattr(r, "tenant", None),
            attribution=attr, n_spans=len(spans)))

    # ---- aggregates --------------------------------------------------------

    def attribution_fractions(self) -> Dict[str, float]:
        return aggregate_fractions(self.records)

    def summary_fields(self) -> Dict[str, float]:
        """The obs block merged into Report/FleetReport summaries (only
        when observability is enabled, so pre-obs goldens are
        untouched)."""
        out = {f"attribution_{k}": v
               for k, v in self.attribution_fractions().items()}
        out["obs_spans"] = len(self.spans)
        out["obs_dropped_spans"] = self.dropped_spans
        out["obs_counter_series"] = len(self.counters)
        return out

    def slowest(self, n: int = 5) -> List[RequestRecord]:
        return sorted(self.records, key=lambda rec: -rec.e2e)[:n]


def attach_telemetry(handle, tel: Optional[Telemetry], *,
                     instance: str = "") -> None:
    """Wire a recorder into a built ``SystemHandle`` (no-op on None)."""
    if tel is None:
        return
    handle.controller.telemetry = tel
    handle.controller.tel_instance = instance
    if handle.fabric is not None:
        handle.fabric.telemetry = tel
    for cname, cluster in handle.clusters.items():
        for w in cluster.replicas:
            w.telemetry = tel
            # replica names repeat across fleet instances — qualify the
            # telemetry identity so the shared recorder never conflates
            # two instances' replicas
            w.tel_name = f"{instance}/{w.name}" if instance else w.name
            tel.register_replica(w.tel_name, cluster=cname,
                                 instance=instance)
            if tel.ep_spans and hasattr(w.predictor, "af_trace"):
                w.predictor.af_trace = tel.af_event
