"""Live slots per decode step over the slot pool: mean of the engine's
``step_log`` ``batch`` over the window's decode steps, over ``max_slots``."""
LAYER = "engine scheduler (serving/engine.py)"
UNIT = "%"
MOVES = "out_tok_s"


def read(w):
    batches = [s["batch"] for s in w.steps if s["kind"] == "decode"]
    if not batches:
        return None
    return 100.0 * sum(batches) / len(batches) / w.max_slots
