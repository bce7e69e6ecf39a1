"""The prefills' share of the card's bf16 peak: the FLOPs the window's real
prompt tokens need (``counts.prefill_flops``, causal, padding not counted)
over the prefills' summed time."""
from perfbench import counts

LAYER = "model step (models/*)"
UNIT = "%"
MOVES = "ttft_p95_ms"


def read(w):
    peak = counts.peak(w.device_name, "bf16_flops")
    pre = [s for s in w.steps if s["kind"] == "prefill"]
    dur = sum(s["dur"] for s in pre)
    if not peak or not dur:
        return None
    flops = sum(counts.prefill_flops(w.shapes, s["tokens"]) for s in pre)
    return 100.0 * flops / (dur * peak)
