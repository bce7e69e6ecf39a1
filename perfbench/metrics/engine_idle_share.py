"""Share of the engine's busy time (its ``run()`` in flight) in which none
of its steps' device work ran: one minus the device seconds of the window's
entries (decode ``device``, prefill ``device`` and ``slot_copy_device``,
from timing events where the work runs) over that time.  The input copies
and the logits' readback lie outside those events and count as idle.  Where
the entries carry no device time, nothing."""
LAYER = "device"
UNIT = "%"
MOVES = "out_tok_s"


def read(w):
    timed = [s for s in w.steps if "device" in s]
    if not timed or w.busy_s <= 0:
        return None
    device = sum(s["device"] + s.get("slot_copy_device", 0.0) for s in timed)
    return 100.0 * (1.0 - device / w.busy_s)
