"""The whole served step's share of the card's bf16 peak over the window:
the model FLOPs of every token the window served (``counts``: each real
prompt token of the prefills that ended in it, causal, and each live decode
token, attention over its live positions) over the window's length.  It
bounds the share of every kernel the window runs."""
from perfbench import counts

LAYER = "model step (models/*)"
UNIT = "%"
MOVES = "out_tok_s"


def read(w):
    peak = counts.peak(w.device_name, "bf16_flops")
    if not peak or w.seconds <= 0:
        return None
    flops = 0
    for r in w.requests:
        inside = sum(t <= w.close for t in r.stamps)
        if inside:
            flops += counts.prefill_flops(w.shapes, len(r.prompt))
            flops += sum(counts.decode_token_flops(w.shapes, p) for p in
                         counts.decode_positions(len(r.prompt), inside))
    return 100.0 * flops / (w.seconds * peak) if flops else None
