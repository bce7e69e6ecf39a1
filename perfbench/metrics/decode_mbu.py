"""The decode steps' share of the memory roofline: the bytes the window's
decode steps need (each weight read once a step, the experts its live
tokens hit, the live KV positions read once and each new entry written
once; ``counts``) over the steps' summed time at the card's HBM peak.  The
copies of the whole cache are not counted, so removing them shows."""
from perfbench import counts

LAYER = "kernels: the decode step's share of the memory roofline"
UNIT = "%"
MOVES = "tpot_p95_ms"


def read(w):
    peak = counts.peak(w.device_name, "hbm_bytes_s")
    dec = [s for s in w.steps if s["kind"] == "decode"]
    dur = sum(s["dur"] for s in dec)
    if not peak or not dur:
        return None
    weights = sum(counts.decode_step_weight_bytes(w.shapes, s["batch"]) for s in dec)
    kv = sum(counts.decode_kv_bytes(w.shapes, p) for r in w.requests if r.ok
             for p in counts.decode_positions(len(r.prompt), len(r.tokens)))
    return 100.0 * (weights + kv) / (dur * peak)
