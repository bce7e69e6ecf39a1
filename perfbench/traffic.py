"""The one generator every traffic mix (``traffic/<mix>.json``) is read by.

A mix is an open loop: requests arrive on a schedule whether or not earlier
ones have finished, as independent users send them.  Its parameters:

- ``source``: where its lengths come from;
- ``slots``, ``max_seq``: the engine's slot pool and per-slot cache length;
- ``rate``: requests a second, arriving as a Poisson process;
- ``judge``: ``"tails"`` for a rate below the knee, the highest rate the
  engine sustains: every request that arrives in the window is served to its
  end and counted; or ``"throughput"`` for a rate above it: the tokens
  served inside the window count, and at its close the requests still
  queued are withdrawn, as their clients would cancel them;
- ``prompt``, ``output``: length distributions, each ``{"dist":
  "lognormal", "median", "sigma", "min", "max"}`` (rounded, clipped) or
  ``{"dist": "uniform", "min", "max"}`` (both ends included);
- ``sizes_seed``: the seed of the schedule, arrival times and lengths
  together.  It is the same for every run, so the run's seed changes the
  token ids (and the weights) and never the work or its timing;
- ``check``: how many finished requests the comparison with the reference
  samples (the longest among them);
- ``trace``: the profiled segment after the window: the schedule replayed
  afresh, unprofiled for ``warm_s`` seconds to reach the window's load, then
  profiled for ``profile_s``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

CHUNK = 1024        # schedule draws per block: a longer window extends it


def draw_lengths(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        v = rng.lognormal(np.log(float(spec["median"])), float(spec["sigma"]), n)
        return np.clip(np.rint(v).astype(np.int64), lo, hi)
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def schedule(mix: Dict, seconds: float) -> List[Tuple[float, int, int]]:
    """(arrival second, prompt length, output length) of every request that
    arrives in ``[0, seconds)``.  Drawn in blocks from ``sizes_seed`` alone,
    so a longer window only extends a shorter one's schedule."""
    rng = np.random.default_rng(int(mix["sizes_seed"]))
    out: List[Tuple[float, int, int]] = []
    t = 0.0
    while True:
        gaps = rng.exponential(1.0 / float(mix["rate"]), CHUNK)
        prompts = draw_lengths(mix["prompt"], CHUNK, rng)
        outputs = draw_lengths(mix["output"], CHUNK, rng)
        for g, p, o in zip(gaps, prompts, outputs):
            t += float(g)
            if t >= seconds:
                return out
            out.append((t, int(p), int(o)))


def seed_words(seed: int) -> List[int]:
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def requests(mix: Dict, seed: int, seconds: float, vocab: int, stream: int = 0
             ) -> List[Tuple[float, np.ndarray, int]]:
    """(arrival second, prompt ids, output length) of the run with ``seed``:
    the schedule's sizes and times, token ids drawn from the seed per
    request.  ``stream`` 1 is the profiled segment's own ids."""
    out = []
    for i, (t, p, o) in enumerate(schedule(mix, seconds)):
        rng = np.random.default_rng(seed_words(seed) + [stream, i])
        out.append((t, rng.integers(0, vocab, p, dtype=np.int64).astype(np.int32), o))
    return out


def prefill_bucket(n: int, max_seq: int) -> int:
    """The engine pads a prompt to a power of two of at least 16, capped
    at ``max_seq``; its prefill (and the MoE capacity there) sees that many
    tokens."""
    b = 16
    while b < n:
        b *= 2
    return min(b, max_seq)


def warm_lengths(mix: Dict) -> List[int]:
    """Prompt lengths that reach every power-of-two bucket the mix's prompt
    range reaches: the range's ends and the largest length in range at
    each power of two between."""
    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    out = {lo, hi}
    b = 16
    while b < hi:
        if b >= lo:
            out.add(b)
        b *= 2
    return sorted(out)
