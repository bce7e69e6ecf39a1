"""Per-request latency attribution.

Partition a request's end-to-end latency ``[arrival, finish]`` into
queue / compute / comm / preempt / stall seconds that sum (within float
rounding) to e2e:

- each recorded span contributes its interval to its category
  (``SPAN_CATEGORY``), clipped to ``[arrival, finish]``;
- overlaps are resolved by a sweep with category priority
  compute > comm > preempt > queue — a KV transfer hidden under a
  prefill chunk books as compute, not twice;
- the uncovered remainder is *stall*: time the request existed but no
  recorded activity owned (head-of-line blocking behind another
  request's batch, waiting for a transfer slot, scheduler gaps).

``stall`` is computed as ``e2e - covered`` so the five components sum
to e2e exactly up to accumulation rounding (property-tested at 1e-6).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from repro_torch.obs.spans import CATEGORY_PRIORITY, Span

ATTRIBUTION_KEYS = ("queue_s", "compute_s", "comm_s", "preempt_s", "stall_s")

_PRIO = {c: i for i, c in enumerate(CATEGORY_PRIORITY)}


def attribution_for(spans: Iterable[Span], arrival: float,
                    finish: float) -> Dict[str, float]:
    """Attribution dict for one request from its recorded spans."""
    e2e = max(finish - arrival, 0.0)
    out = {k: 0.0 for k in ATTRIBUTION_KEYS}
    if e2e <= 0.0:
        return out
    # clipped (start, end, priority) intervals
    ivals: List[Tuple[float, float, int]] = []
    for s in spans:
        cat = s.category
        if cat is None:
            continue
        a = s.start if s.start > arrival else arrival
        b = s.end if s.end < finish else finish
        if b > a:
            ivals.append((a, b, _PRIO[cat]))
    if not ivals:
        out["stall_s"] = e2e
        return out
    # sweep over elementary intervals between all boundaries; each
    # elementary interval is owned by the highest-priority category
    # covering it
    bounds = sorted({v for a, b, _ in ivals for v in (a, b)})
    sums = [0.0] * len(CATEGORY_PRIORITY)
    covered = 0.0
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        best = -1
        for a, b, p in ivals:
            if a <= lo and b >= hi and (best < 0 or p < best):
                best = p
                if p == 0:
                    break
        if best >= 0:
            w = hi - lo
            sums[best] += w
            covered += w
    out["compute_s"] = sums[_PRIO["compute"]]
    out["comm_s"] = sums[_PRIO["comm"]]
    out["preempt_s"] = sums[_PRIO["preempt"]]
    out["queue_s"] = sums[_PRIO["queue"]]
    out["stall_s"] = max(e2e - covered, 0.0)
    return out


def aggregate_fractions(records) -> Dict[str, float]:
    """Fleet/run-level attribution fractions over all finished requests:
    per-category seconds summed across requests, divided by total e2e."""
    tot = {k: 0.0 for k in ATTRIBUTION_KEYS}
    e2e = 0.0
    for rec in records:
        e2e += rec.e2e
        for k in ATTRIBUTION_KEYS:
            tot[k] += rec.attribution[k]
    if e2e <= 0.0:
        return {k.replace("_s", "_frac"): 0.0 for k in ATTRIBUTION_KEYS}
    return {k.replace("_s", "_frac"): tot[k] / e2e for k in ATTRIBUTION_KEYS}
