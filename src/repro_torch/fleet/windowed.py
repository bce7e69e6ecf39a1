"""Conservative time-window execution of a fleet simulation.

Serial fleet mode interleaves every instance on ONE event heap — exact,
but each of a million events pays global heap discipline.  Windowed mode
gives each instance its own sub-engine and advances the whole fleet in
conservative time windows:

1. pick the next barrier ``T`` = earliest pending event across the fleet
   engine and every instance engine;
2. run the FLEET engine through ``[T, T + window_s]`` — arrivals routed
   in this window register eagerly but fire on the target instance's
   engine at their true arrival time (see ``FleetController._accept``);
3. run every instance engine through the same window, in instance
   creation order.

The schedule is deterministic given ``window_s``: the same spec + seed +
window replays the same event order.  ``window_s == 0`` degenerates to
one barrier per distinct timestamp — the same event times and handler
arguments as serial mode, so results reproduce serial output exactly
unless distinct engines collide at an identical float timestamp (the
equivalence the fleet test suite locks on a golden spec).  Larger windows
amortize barrier overhead; cross-instance signals (router load counts,
autoscaler queue depths) are then stale by at most ``window_s`` simulated
seconds — the classic conservative-DES trade.
"""
from __future__ import annotations

from typing import List


def run_windowed(fc, until: float, window_s: float) -> None:
    """Drive a windowed FleetController to completion (or ``until``)."""
    fleet = fc.engine
    while True:
        engines: List = []
        seen = {id(fleet)}
        for inst in fc.instances.values():     # insertion order: stable
            e = inst.handle.engine
            if id(e) not in seen:
                seen.add(id(e))
                engines.append(e)
        times = [t for t in (e.peek_time() for e in [fleet] + engines)
                 if t is not None]
        if not times:
            # drained: align every clock to the global end time, so
            # duration-normalized observables (utilization, GPU-seconds)
            # read the same denominator as serial mode's shared clock
            end = max(e.now for e in [fleet] + engines)
            for e in [fleet] + engines:
                e.advance_to(end)
            return
        barrier = min(times)
        if barrier > until:
            # horizon cut: clamp every clock to the horizon and stop
            for e in [fleet] + engines:
                e.run(until)
            return
        hi = min(barrier + window_s, until)
        # control plane first: instances are at or behind the barrier, so
        # every arrival routed here defers onto an instance engine at a
        # time that engine has not yet reached (conservative-safe)
        fleet.run(hi)
        for e in engines:
            e.run(hi)
        # instances built by fleet events in this window (scale-up) enter
        # at the next barrier; their engines start at the fleet clock
