"""Frozen arithmetic: the percentile the tails are read with.

``pct`` is a copy of the program's ``repro_torch/core/metrics.py::_pct``
(numpy's linear percentile), kept here so that a change to the program
cannot move the yardstick.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def pct(xs: Sequence[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else None
