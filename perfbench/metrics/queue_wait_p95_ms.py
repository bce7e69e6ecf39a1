"""How long the engine held a request before its prefill began: p95 over
the window's prefill entries of ``queued`` (the entry's ``start`` less the
request's ``submitted``, both on the engine's clock, from its own
``submit``).  Where the entries carry no ``queued``, nothing."""
from perfbench.stats import pct

LAYER = "engine scheduler (serving/engine.py)"
UNIT = "ms"
MOVES = "ttft_p95_ms"


def read(w):
    waits = [1e3 * s["queued"] for s in w.steps
             if s["kind"] == "prefill" and "queued" in s]
    return pct(waits, 95)
