"""Synchronised prefill time (one replay per request, of its bucket's
graph) per thousand real prompt tokens; padding not counted."""
LAYER = "compiled step (graphs.py replays)"
UNIT = "ms"
MOVES = "ttft_p95_ms"


def read(w):
    pre = [s for s in w.steps if s["kind"] == "prefill"]
    toks = sum(s["tokens"] for s in pre)
    return 1e6 * sum(s["dur"] for s in pre) / toks if toks else None
