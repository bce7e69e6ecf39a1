"""Share of the engine's busy time (its ``run()`` in flight) in which no
synchronised step was: one minus the sum of the ``step_log`` ``dur`` of the
window over that time.  What is left is the host's: argmax, slot copies,
admission, bookkeeping, and it lengthens every gap between tokens."""
LAYER = "engine host path (serving/engine.py)"
UNIT = "%"
MOVES = "tpot_p95_ms"


def read(w):
    if not w.steps or w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sum(s["dur"] for s in w.steps) / w.busy_s)
