"""Sim-time counter timeseries with bounded memory.

Counters are sampled at simulation events (never wall clock): batch
occupancy when a batch is planned, KV blocks at batch boundaries, fabric
flow counts at every repricing, $-burn at scale events.  Long runs would
otherwise accumulate unbounded points, so each series is *windowed
down*: when a series exceeds ``2 * max_points`` it is decimated by
merging adjacent sample pairs (keeping the first timestamp and the
max value — counters here are gauges, and the max preserves the peaks
that diagnosis cares about).  The result is at most ``2 * max_points``
samples per series at any moment, with uniform-in-index coverage of the
whole run.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple


class CounterBoard:
    """Named (t, value) series keyed by counter name."""

    def __init__(self, max_points: int = 4096):
        self.max_points = max(int(max_points), 2)
        self._series: Dict[str, List[Tuple[float, float]]] = {}
        # per-series downsampling stride (grows by 2x each decimation)
        self._stride: Dict[str, int] = {}
        self._skip: Dict[str, int] = {}
        # per-series identity scope for export: (replica, instance)
        self._scope: Dict[str, Tuple[str, str]] = {}

    def sample(self, name: str, t: float, value: float, *,
               replica: str = "", instance: str = "") -> None:
        pts = self._series.get(name)
        if pts is None:
            pts = self._series[name] = []
            self._stride[name] = 1
            self._skip[name] = 0
            self._scope[name] = (replica, instance)
        stride = self._stride[name]
        if stride > 1:
            # drop (stride - 1) of every stride incoming samples, but
            # fold their value into the kept point's max so peaks survive
            skip = self._skip[name]
            if skip:
                self._skip[name] = skip - 1
                last = pts[-1]
                if value > last[1]:
                    pts[-1] = (last[0], value)
                return
            self._skip[name] = stride - 1
        pts.append((t, value))
        if len(pts) > 2 * self.max_points:
            self._decimate(name)

    def _decimate(self, name: str) -> None:
        pts = self._series[name]
        merged = []
        for i in range(0, len(pts) - 1, 2):
            t0, v0 = pts[i]
            v1 = pts[i + 1][1]
            merged.append((t0, v0 if v0 >= v1 else v1))
        if len(pts) % 2:
            merged.append(pts[-1])
        self._series[name] = merged
        self._stride[name] *= 2
        self._skip[name] = 0

    def series(self, name: str) -> List[Tuple[float, float]]:
        return list(self._series.get(name, ()))

    def scope(self, name: str) -> Tuple[str, str]:
        return self._scope.get(name, ("", ""))

    def names(self) -> List[str]:
        return sorted(self._series)

    def __len__(self) -> int:
        return len(self._series)

    def items(self) -> Iterator[Tuple[str, List[Tuple[float, float]]]]:
        for name in self.names():
            yield name, self._series[name]

    def last(self, name: str) -> Optional[float]:
        pts = self._series.get(name)
        return pts[-1][1] if pts else None

    def to_dict(self) -> dict:
        return {name: [[t, v] for t, v in pts] for name, pts in self.items()}
