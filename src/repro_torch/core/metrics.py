"""Serving metrics: TTFT / TPOT / throughput / goodput / Pareto frontier."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Request


def _pct(xs: Sequence[float], q: float) -> Optional[float]:
    # None (JSON null), NOT nan: a bare NaN literal makes the report an
    # invalid JSON document, silently breaking CLI/sweep artifacts
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else None


def _mean(xs: Sequence[float]) -> Optional[float]:
    return float(np.mean(xs)) if len(xs) else None


@dataclass
class MetricsCollector:
    completed: List[Request] = field(default_factory=list)
    # token events are counted, not stored: a per-token timestamp list is
    # O(total output tokens) memory (hundreds of MB at million-request
    # scale) and nothing consumed the individual times
    token_count: int = 0
    # measurement-window start: anchored to the FIRST request arrival by the
    # controller (None until then) — measuring from t=0 silently inflates
    # the duration whenever the first arrival is late
    start: Optional[float] = None
    end: float = 0.0

    def on_token(self, r: Request, replica, t: float) -> None:
        self.token_count += 1
        if t > self.end:
            self.end = t

    def on_complete(self, r: Request, replica) -> None:
        self.completed.append(r)
        self.end = max(self.end, r.finish_time or 0.0)

    # ------------------------------------------------------------- report --
    def report(self, *, n_devices: int = 1,
               slo_ttft: Optional[float] = None,
               slo_tpot: Optional[float] = None
               ) -> Dict[str, Optional[float]]:
        """Summary metrics; empty-sample statistics are ``None`` (JSON
        null), never NaN — reports must stay valid JSON."""
        start = self.start
        if start is None:       # no arrival was ever observed
            start = min((r.arrival for r in self.completed), default=0.0)
        dur = max(self.end - start, 1e-9)
        ttfts = [r.ttft() for r in self.completed if r.ttft() is not None]
        tpots = [r.tpot() for r in self.completed if r.tpot() is not None]
        e2es = [r.e2e() for r in self.completed if r.e2e() is not None]
        # every completed request contributes a queue delay: one that was
        # never stamped ``first_scheduled`` (scheduled the instant it
        # arrived, before any stamping seam ran) waited 0.0 — dropping it
        # would bias the percentiles upward over exactly the fastest
        # requests
        queues = [r.timestamps.get("first_scheduled", r.arrival) - r.arrival
                  for r in self.completed]
        out_tokens = sum(r.generated for r in self.completed)
        rep = {
            "n_completed": len(self.completed),
            "duration_s": dur,
            "throughput_tok_s": out_tokens / dur,
            "throughput_tok_s_per_device": out_tokens / dur / max(n_devices, 1),
            "ttft_mean_s": _mean(ttfts),
            "ttft_p50_s": _pct(ttfts, 50), "ttft_p99_s": _pct(ttfts, 99),
            "tpot_mean_s": _mean(tpots),
            "tpot_p50_s": _pct(tpots, 50), "tpot_p99_s": _pct(tpots, 99),
            "e2e_mean_s": _mean(e2es),
            "e2e_p50_s": _pct(e2es, 50), "e2e_p99_s": _pct(e2es, 99),
            "queue_mean_s": _mean(queues),
            "queue_p50_s": _pct(queues, 50), "queue_p99_s": _pct(queues, 99),
            # preemption/restore observability (memory-pressure dynamics)
            "preempted_requests": sum(1 for r in self.completed
                                      if r.preemptions > 0),
            "request_preemptions": sum(r.preemptions for r in self.completed),
        }
        if slo_ttft is not None and slo_tpot is not None and self.completed:
            good = [r for r in self.completed
                    if _meets_slo(r, slo_ttft, slo_tpot)]
            rep["goodput_tok_s"] = sum(r.generated for r in good) / dur
            rep["slo_attainment"] = len(good) / len(self.completed)
        return rep

    # --------------------------------------------------------- fleet views --
    @classmethod
    def merged(cls, collectors: Sequence["MetricsCollector"]
               ) -> "MetricsCollector":
        """Fleet-wide view over per-instance collectors: one measurement
        window anchored at the earliest instance start, all completions and
        token events pooled (each request completes on exactly one
        instance, so pooling never double-counts)."""
        out = cls()
        starts = [c.start for c in collectors if c.start is not None]
        out.start = min(starts) if starts else None
        out.end = max((c.end for c in collectors), default=0.0)
        for c in collectors:
            out.completed.extend(c.completed)
            out.token_count += c.token_count
        return out


def _meets_slo(r: Request, ttft_s: Optional[float],
               tpot_s: Optional[float]) -> bool:
    """One SLO predicate for goodput and attainment (a request with no
    measured TTFT/TPOT never meets a bound)."""
    if ttft_s is not None and (r.ttft() or 9e9) > ttft_s:
        return False
    if tpot_s is not None and (r.tpot() or 9e9) > tpot_s:
        return False
    return True


def slo_attainment(requests: Sequence[Request],
                   ttft_s: Optional[float] = None,
                   tpot_s: Optional[float] = None) -> Optional[float]:
    """Fraction of ``requests`` meeting the given SLO bounds (None bound =
    don't check it); None when there are no requests or no bounds."""
    if not requests or (ttft_s is None and tpot_s is None):
        return None
    return sum(1 for r in requests
               if _meets_slo(r, ttft_s, tpot_s)) / len(requests)


def pareto_frontier(points: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """(throughput, interactivity=1/tpot) maximization frontier."""
    pts = sorted(points, key=lambda p: (-p[0], -p[1]))
    front, best = [], -np.inf
    for x, y in pts:
        if y > best:
            front.append((x, y))
            best = y
    return front
