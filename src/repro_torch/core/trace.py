"""Event tracing: in-memory ring + Chrome trace-event export."""
from __future__ import annotations

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

        The export is a thin shim over the observability layer's chrome
        sink, which is not ported yet (ROADMAP Queue A item 7), so this
        raises rather than write nothing.
        """
        raise NotImplementedError(
            "EventTrace.to_chrome_trace: the chrome sink lives in the "
            "observability layer (obs/), which is ROADMAP Queue A item 7 "
            "and not ported yet")
