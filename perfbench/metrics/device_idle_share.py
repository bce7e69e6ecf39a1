"""Share of the window in which no kernel ran on the card: one minus the
mean of NVML's utilisation samples taken inside the unprofiled window."""
LAYER = "device"
UNIT = "%"
MOVES = "out_tok_s"


def read(w):
    if w.nvml_busy_percent is None:
        return None
    return 100.0 - w.nvml_busy_percent
