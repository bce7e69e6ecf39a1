"""Typed request spans.

A span is one closed interval of a request's lifecycle on one resource:
a prefill chunk on a replica, a KV transfer on a link, a swap to host
memory, an EP rank's GroupedGEMM inside one decode step.  Spans carry
the replica that produced them; cluster/instance identity is resolved
through the :class:`~repro_torch.obs.telemetry.Telemetry` registry at export
time so the hot-path record stays small.

``SPAN_CATEGORY`` maps each span kind to the latency-attribution bucket
it occupies (queue / compute / comm / preempt).  Kinds mapped to
``None`` are nested detail — EP sub-graph markers live *inside* a decode
epoch, so counting them again would double-book compute time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

# span kind -> attribution category (None = nested detail, not attributed)
SPAN_CATEGORY: Dict[str, Optional[str]] = {
    "queue_wait": "queue",
    "fleet_route": "queue",
    "prefill_chunk": "compute",
    "decode": "compute",
    "preempt": "preempt",
    "recompute_requeue": "preempt",
    "swap_out": "preempt",
    "swap_in": "preempt",
    "kv_transfer": "comm",
    "ep_dispatch": None,
    "ep_rank": None,
    "ep_combine": None,
}

# category priority for the attribution sweep: when intervals overlap
# (a prefill chunk hiding a KV transfer), the highest-priority category
# owns the overlap
CATEGORY_PRIORITY = ("compute", "comm", "preempt", "queue")


@dataclass
class Span:
    """One typed interval.  ``rid < 0`` marks request-agnostic spans
    (EP sub-graph markers belong to a batch, not a single request)."""
    kind: str
    rid: int
    start: float
    end: float
    replica: str = ""
    meta: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.end - self.start

    @property
    def category(self) -> Optional[str]:
        return SPAN_CATEGORY.get(self.kind)

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "rid": self.rid, "start": self.start,
             "end": self.end, "replica": self.replica}
        if self.meta:
            d["meta"] = self.meta
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(kind=d["kind"], rid=d["rid"], start=d["start"],
                   end=d["end"], replica=d.get("replica", ""),
                   meta=d.get("meta") or {})
