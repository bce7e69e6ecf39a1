"""Event tracing: in-memory ring + Chrome trace-event export."""
from __future__ import annotations

import json
from collections import deque
from typing import Deque, List, Optional

from repro_torch.core.events import EV, Event


class EventTrace:
    def __init__(self, capacity: int = 200_000):
        self.events: Deque[tuple] = deque(maxlen=capacity)

    def __call__(self, ev: Event) -> None:
        d = ev.data
        if not isinstance(d, dict):      # timeline payloads are raw objects
            d = {} if d is None else {"data": d}
        self.events.append((ev.time, ev.kind.value, dict(d)))

    def filter(self, kind: EV) -> List[tuple]:
        return [e for e in self.events if e[1] == kind.value]

    def to_chrome_trace(self, path: str) -> None:
        """Chrome trace-event export of the raw ring.

        .. deprecated::
            Thin shim over
            :func:`repro_torch.obs.sinks.engine_events_to_chrome` (which fixed
            the negative-``ts`` clamp and honours ``dur`` on any event
            kind, not just BATCH_DONE).  Prefer the span-level
            observability layer: ``SimSpec(obs=ObsSpec())`` +
            ``repro_torch.obs.write_chrome_trace``.
        """
        from repro_torch.obs.sinks import engine_events_to_chrome
        with open(path, "w") as f:
            json.dump({"traceEvents": engine_events_to_chrome(self.events)},
                      f)
