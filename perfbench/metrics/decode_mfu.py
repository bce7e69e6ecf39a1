"""The decode steps' share of the card's bf16 peak: the model FLOPs the
window's live decode tokens need (``counts.decode_token_flops``: weights,
attention over the live positions, the head) over the steps' summed time."""
from perfbench import counts

LAYER = "model step (models/*)"
UNIT = "%"
MOVES = "tpot_p95_ms"


def read(w):
    peak = counts.peak(w.device_name, "bf16_flops")
    dur = sum(s["dur"] for s in w.steps if s["kind"] == "decode")
    if not peak or not dur:
        return None
    flops = sum(counts.decode_token_flops(w.shapes, p) for r in w.requests if r.ok
                for p in counts.decode_positions(len(r.prompt), len(r.tokens)))
    return 100.0 * flops / (dur * peak)
