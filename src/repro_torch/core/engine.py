"""Deterministic discrete-event simulation engine.

Events are ordered by (time, seq) — seq is a global monotone counter so
simultaneous events replay in schedule order, making every simulation
bit-reproducible (property-tested).

Hot-path design (the vectorized event core):

- heap entries are ``(time, seq, Event)`` tuples, so ``heapq`` ordering
  resolves with C-level tuple comparison instead of Python ``__lt__``
  dispatch, and :class:`Event` itself is a ``__slots__`` class (no
  per-event dict);
- a bulk **timeline** source (:meth:`schedule_timeline`) holds pre-sorted
  event streams (request arrivals) as plain tuples consumed by index —
  a million arrivals never enter the heap at all, and their Event objects
  materialize lazily at dispatch;
- **same-timestamp batching**: kinds registered through
  :meth:`register_batch_handler` have contiguous runs of events at an
  identical timestamp drained into one list and dispatched as a single
  call.  Only contiguous same-(time, kind) runs are grouped, so the global
  (time, seq) replay order is preserved exactly — with no handlers
  registered the engine is bit-identical to pre-batching behavior.
"""
from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.events import EV, Event, _seq


class SimEngine:
    def __init__(self, *, trace: Optional[Callable[[Event], None]] = None,
                 max_events: int = 50_000_000):
        self.now = 0.0
        self._heap: List[Tuple[float, int, Event]] = []
        self._timeline: List[tuple] = []   # (time, seq, kind, fn, data)
        self._tl_i = 0
        self._trace = trace
        self._processed = 0
        self._max_events = max_events
        self._batch_handlers: Dict[EV, Callable[[List[Event]], None]] = {}

    # ------------------------------------------------------------------ API
    def at(self, time: float, kind: EV, fn: Callable[[Event], None],
           **data) -> Event:
        assert time >= self.now - 1e-12, (time, self.now)
        ev = Event(max(time, self.now), kind, fn, data if data else None)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def after(self, delay: float, kind: EV, fn: Callable[[Event], None],
              **data) -> Event:
        return self.at(self.now + max(delay, 0.0), kind, fn, **data)

    def schedule_timeline(self, items: Iterable[Tuple[float, EV,
                                                      Callable, Any]]) -> int:
        """Bulk-schedule a time-sorted event stream without heap traffic.

        ``items`` yields ``(time, kind, fn, data)`` in non-decreasing time
        order (data may be any payload object, not just a dict).  Sequence
        numbers are assigned immediately, in order — ties against events
        pushed with :meth:`at` afterwards break exactly as if every item
        had been pushed here and now.  Returns the number of items added.
        """
        tl = self._timeline
        last = tl[-1][0] if tl else -float("inf")
        n0 = len(tl)
        for time, kind, fn, data in items:
            if time < last:
                raise ValueError(
                    f"timeline items must be sorted by time and follow "
                    f"any previous timeline: {time} < {last} (use at() "
                    f"for out-of-order events)")
            if time < self.now - 1e-12:
                raise ValueError(f"timeline event in the past: "
                                 f"{time} < now={self.now}")
            last = time
            tl.append((time, next(_seq), kind, fn, data))
        return len(tl) - n0

    def register_batch_handler(self, kind: EV,
                               fn: Callable[[List[Event]], None]) -> None:
        """Dispatch contiguous same-timestamp runs of ``kind`` as one call.

        The handler receives the events in schedule (seq) order.  Grouping
        never crosses a different-kind event or a timestamp change, so the
        deterministic replay order is unchanged; only the *call shape*
        differs (one call for N events instead of N calls).
        """
        self._batch_handlers[kind] = fn

    def advance_to(self, time: float) -> None:
        """Advance the clock to ``time`` with no event dispatch (used by
        the windowed fleet mode to bring idle instance engines up to a
        synchronization barrier).  Never rewinds; refuses to skip over
        pending events."""
        if time <= self.now:
            return
        nxt = self.peek_time()
        assert nxt is None or nxt >= time - 1e-12, (nxt, time)
        self.now = time

    def peek_time(self) -> Optional[float]:
        """Timestamp of the next pending event (None when drained)."""
        t = self._heap[0][0] if self._heap else None
        i = self._tl_i
        if i < len(self._timeline):
            t2 = self._timeline[i][0]
            if t is None or t2 < t:
                return t2
        return t

    # ------------------------------------------------------------ run loop
    def run(self, until: float = float("inf")) -> None:
        heap = self._heap
        tl = self._timeline
        trace = self._trace
        batch = self._batch_handlers
        max_events = self._max_events
        pop = heapq.heappop
        n_tl = len(tl)
        while True:
            i = self._tl_i
            if heap:
                entry = heap[0]
                use_tl = (i < n_tl and entry[0] >= tl[i][0]
                          and (tl[i][0], tl[i][1]) < (entry[0], entry[1]))
            elif i < n_tl:
                use_tl = True
            else:
                break
            t = tl[i][0] if use_tl else entry[0]
            if t > until:
                break
            if self._processed >= max_events:
                raise RuntimeError(
                    f"simulation event budget exceeded: max_events="
                    f"{max_events}, processed={self._processed}, "
                    f"pending={self.pending}, now={self.now}")
            if use_tl:
                self._tl_i = i + 1
                item = tl[i]
                kind = item[2]
                ev = Event(t, kind, item[3], item[4], seq=item[1])
            else:
                pop(heap)
                ev = entry[2]
                kind = ev.kind
            self.now = t
            self._processed += 1
            if trace is not None:
                trace(ev)
            if batch and kind in batch:
                evs = [ev]
                self._drain_matching(t, kind, evs)
                batch[kind](evs)
            elif ev.fn is not None:
                ev.fn(ev)
            n_tl = len(tl)   # handlers may have extended the timeline
        if self.pending and self.peek_time() > until:
            self.now = until

    def _drain_matching(self, t: float, kind: EV,
                        out: List[Event]) -> None:
        """Pop the contiguous run of events at time ``t`` of ``kind`` (the
        batch-dispatch tail; stops at the first different kind/time so seq
        order is preserved)."""
        heap, tl, trace = self._heap, self._timeline, self._trace
        while True:
            i = self._tl_i
            nxt_tl = tl[i] if i < len(tl) else None
            nxt_h = heap[0] if heap else None
            if nxt_tl is not None and (
                    nxt_h is None
                    or (nxt_tl[0], nxt_tl[1]) < (nxt_h[0], nxt_h[1])):
                if nxt_tl[0] != t or nxt_tl[2] is not kind:
                    return
                self._tl_i = i + 1
                ev = Event(t, kind, nxt_tl[3], nxt_tl[4], seq=nxt_tl[1])
            elif nxt_h is not None:
                if nxt_h[0] != t or nxt_h[2].kind is not kind:
                    return
                heapq.heappop(heap)
                ev = nxt_h[2]
            else:
                return
            self._processed += 1
            if trace is not None:
                trace(ev)
            out.append(ev)

    @property
    def pending(self) -> int:
        return len(self._heap) + len(self._timeline) - self._tl_i

    @property
    def processed(self) -> int:
        return self._processed
