"""Mean host-clock time of a synchronised decode step (the replay of the
captured ``MiniEngine._decode_body``), over the window's decode steps."""
LAYER = "compiled step (graphs.py replays)"
UNIT = "ms"
MOVES = "tpot_p95_ms"


def read(w):
    durs = [s["dur"] for s in w.steps if s["kind"] == "decode"]
    return 1e3 * sum(durs) / len(durs) if durs else None
