"""Share of the decode steps' device time spent copying the cache the
model returns back into the slot cache (``_decode_body``'s copy loop): the
sum of the window's decode entries' ``copyback`` over the sum of their
``device``, both read from timing events captured in the decode step's
graph.  Where the entries carry no device time, nothing."""
LAYER = "compiled step (graphs.py replays)"
UNIT = "%"
MOVES = "out_tok_s"


def read(w):
    dec = [s for s in w.steps if s["kind"] == "decode" and "copyback" in s]
    device = sum(s["device"] for s in dec)
    return 100.0 * sum(s["copyback"] for s in dec) / device if device > 0 else None
