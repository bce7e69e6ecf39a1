"""Queue-ordering policies for ClusterSchedulers."""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.request import Request


class QueuePolicy:
    name = "base"

    def order(self, queue: List[Request], now: float) -> List[Request]:
        raise NotImplementedError


class FCFS(QueuePolicy):
    name = "fcfs"

    def order(self, queue, now):
        return sorted(queue, key=lambda r: (r.arrival, r.rid))


class SJF(QueuePolicy):
    """Shortest prompt first (reduces head-of-line blocking for prefill)."""
    name = "sjf"

    def order(self, queue, now):
        return sorted(queue, key=lambda r: (r.prompt_len, r.arrival, r.rid))


class Priority(QueuePolicy):
    """External priority in request.timestamps['priority'] (lower first)."""
    name = "priority"

    def order(self, queue, now):
        return sorted(queue, key=lambda r: (r.timestamps.get("priority", 0.0),
                                            r.arrival, r.rid))


POLICIES = {p.name: p for p in (FCFS(), SJF(), Priority())}

SCHEDULERS = {c.name: c for c in (FCFS, SJF, Priority)}


def resolve_scheduler(spec) -> Optional[QueuePolicy]:
    """Uniform queue-policy argument handling (mirrors resolve_router).

    Accepts an instance, a registered name ("fcfs", "sjf", "priority"),
    a mapping ``{"name": ..., **kwargs}``, or None.
    """
    if spec is None or isinstance(spec, QueuePolicy):
        return spec
    if isinstance(spec, str):
        spec = {"name": spec}
    if isinstance(spec, dict):
        kw = dict(spec)
        name = kw.pop("name", None)
        if name not in SCHEDULERS:
            raise KeyError(f"unknown queue policy {name!r}; "
                           f"registered: {sorted(SCHEDULERS)}")
        return SCHEDULERS[name](**kw)
    raise TypeError(f"scheduler must be None, a name, a mapping, or a "
                    f"QueuePolicy; got {type(spec).__name__}")
