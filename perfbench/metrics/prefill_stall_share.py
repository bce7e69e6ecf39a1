"""Share of the served requests' decode time spent behind other requests'
prefills.  Each request of two tokens or more, served to its end, spans
(its first token, its last] on the benchmark's stamps; the prefill entries'
[``start``, ``end``] (the engine's own, on the same ``perf_counter`` clock)
that overlap it, its own prefill left out (the one whose span holds its
first token), are time it waited.  The sum of the overlaps over the sum of
the spans.  Where the entries carry no ``start``, nothing."""
LAYER = "engine scheduler (serving/engine.py)"
UNIT = "%"
MOVES = "tpot_p95_ms"


def read(w):
    spans = [(s["start"], s["end"]) for s in w.steps
             if s["kind"] == "prefill" and "start" in s]
    if not spans:
        return None
    stalled = total = 0.0
    for r in w.requests:
        if not r.ok or len(r.stamps) < 2:
            continue
        a, b = r.stamps[0], r.stamps[-1]
        total += b - a
        stalled += sum(max(0.0, min(e, b) - max(s, a)) for s, e in spans
                       if not s <= a <= e)
    return 100.0 * stalled / total if total > 0 else None
