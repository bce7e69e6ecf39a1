"""Workload generation: request traces with configurable arrivals/lengths."""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.request import Request

ARRIVALS = ("poisson", "uniform", "burst", "closed")
RATE_CURVES = ("diurnal",)


@dataclass
class WorkloadConfig:
    n_requests: int = 100
    arrival: str = "poisson"            # "poisson" | "uniform" | "burst" | "closed"
    rate: float = 4.0                   # requests/s (open-loop)
    prompt: str = "lognormal"           # "fixed" | "uniform" | "lognormal" | "bimodal"
    prompt_mean: int = 512
    prompt_max: int = 8192
    output: str = "lognormal"
    output_mean: int = 128
    output_max: int = 2048
    # burst arrivals: bursts of burst_size requests every burst_period sec
    burst_size: int = 32
    burst_period: float = 1.0
    # closed-loop arrivals: at most `concurrency` requests in flight; the
    # next request is injected when a slot frees (controller-driven — the
    # generator only stamps placeholder t=0 arrivals, re-stamped at run time)
    concurrency: Optional[int] = None
    # shared-prefix traces (prefix caching has something to hit): each
    # request joins one of `prefix_groups` system-prompt groups and its
    # prompt is prefix_len shared tokens + the drawn unique suffix
    prefix_groups: int = 0
    prefix_len: int = 0
    # multi-turn conversations: n_requests are grouped into conversations
    # of `turns` turns; turn t's prompt is the full history (a growing
    # shared prefix) + a fresh drawn user turn, arriving turn_gap apart.
    # Open-loop approximation: turns arrive on the fixed gap even if the
    # previous turn is still decoding — pick turn_gap above the expected
    # per-turn latency, or the growing prefix will not be cached yet and
    # the history prefills as fresh compute (hit rates degrade honestly
    # under congestion, as an impatient client's would)
    turns: int = 1
    turn_gap: float = 5.0
    # fleet-scale arrival shaping: "diurnal" modulates the poisson rate
    # sinusoidally — lambda(t) = rate * (1 + amplitude*sin(2*pi*t/period)) —
    # so autoscalers have a realistic load swing to chase.  Arrivals come
    # from the exact non-homogeneous process via time rescaling (unit-rate
    # exponential gaps inverted through the integrated rate), not thinning,
    # so the trace is deterministic in the seed.
    rate_curve: Optional[str] = None      # None | "diurnal"
    rate_period: float = 60.0             # seconds per diurnal cycle
    rate_amplitude: float = 0.5           # relative swing, in [0, 1)
    seed: int = 0


def _lengths(kind: str, mean: int, maxv: int, n: int,
             rng: np.random.Generator) -> np.ndarray:
    if kind == "fixed":
        return np.full(n, mean, np.int64)
    if kind == "uniform":
        return rng.integers(1, 2 * mean, n)
    if kind == "bimodal":
        short = rng.integers(max(mean // 8, 1), mean // 2, n)
        long_ = rng.integers(mean * 2, mean * 4, n)
        pick = rng.random(n) < 0.7
        return np.where(pick, short, long_)
    # lognormal with mean ~= mean (ShareGPT-ish heavy tail)
    sigma = 1.0
    mu = np.log(mean) - sigma ** 2 / 2
    v = rng.lognormal(mu, sigma, n)
    return np.clip(v.astype(np.int64), 1, maxv)


def _diurnal_arrivals(cfg: WorkloadConfig, n: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Non-homogeneous poisson arrivals under the diurnal rate curve.

    Time rescaling: draw unit-rate exponential targets s_i, then invert the
    integrated rate Lambda(t) = rate*(t + A*P/(2*pi)*(1 - cos(2*pi*t/P)))
    by (vectorized) bisection — Lambda is strictly increasing for A < 1.
    """
    a, period, rate = cfg.rate_amplitude, cfg.rate_period, cfg.rate
    if a <= 0:
        gaps = rng.exponential(1.0 / rate, n)
        return np.cumsum(gaps)
    targets = np.cumsum(rng.exponential(1.0, n))
    w = 2.0 * np.pi / period

    def big_lambda(t):
        return rate * (t + a / w * (1.0 - np.cos(w * t)))

    lo = np.zeros(n)
    # lambda(t) >= rate*(1-a) everywhere, so t <= s / (rate*(1-a))
    hi = targets / (rate * (1.0 - a)) + period
    for _ in range(64):           # ~2e-19 relative interval after 64 halvings
        mid = 0.5 * (lo + hi)
        below = big_lambda(mid) < targets
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def generate(cfg: WorkloadConfig) -> List[Request]:
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_requests
    if cfg.rate_curve is not None and cfg.rate_curve not in RATE_CURVES:
        raise ValueError(f"unknown rate_curve {cfg.rate_curve!r}; "
                         f"known: {RATE_CURVES}")
    if cfg.rate_curve == "diurnal":
        if cfg.arrival != "poisson":
            raise ValueError("rate_curve='diurnal' modulates the poisson "
                             f"arrival process; got arrival={cfg.arrival!r}")
        if not 0.0 <= cfg.rate_amplitude < 1.0:
            # amplitude >= 1 makes the integrated rate non-invertible
            # (lambda touches zero) — fail instead of emitting inf/garbage
            raise ValueError(f"rate_amplitude must be in [0, 1), "
                             f"got {cfg.rate_amplitude}")
        if cfg.rate_period <= 0:
            raise ValueError(f"rate_period must be > 0, "
                             f"got {cfg.rate_period}")
    if cfg.arrival == "poisson":
        if cfg.rate_curve == "diurnal":
            arrivals = _diurnal_arrivals(cfg, n, rng)
        else:
            gaps = rng.exponential(1.0 / cfg.rate, n)
            arrivals = np.cumsum(gaps)
    elif cfg.arrival == "uniform":
        arrivals = np.sort(rng.uniform(0, n / cfg.rate, n))
    elif cfg.arrival == "burst":
        # ramp of bursts: burst_size simultaneous requests every burst_period
        size = max(int(cfg.burst_size), 1)
        arrivals = (np.arange(n) // size) * max(cfg.burst_period, 0.0)
    elif cfg.arrival == "closed":
        if cfg.concurrency is not None and cfg.concurrency < 1:
            raise ValueError(f"closed-loop concurrency must be >= 1, "
                             f"got {cfg.concurrency}")
        # placeholders: the controller injects request i+concurrency when
        # request i completes (see GlobalController.submit_closed)
        arrivals = np.zeros(n)
    else:
        raise ValueError(f"unknown arrival process {cfg.arrival!r}; "
                         f"known: {ARRIVALS}")
    plens = _lengths(cfg.prompt, cfg.prompt_mean, cfg.prompt_max, n, rng)
    olens = _lengths(cfg.output, cfg.output_mean, cfg.output_max, n, rng)
    if cfg.turns > 1 and cfg.prefix_groups > 0:
        raise ValueError("turns > 1 and prefix_groups > 0 are mutually "
                         "exclusive workload shapes")
    if cfg.turns > 1:
        return _multiturn(cfg, arrivals, plens, olens)
    reqs = [Request(rid=i, arrival=float(arrivals[i]),
                    prompt_len=int(plens[i]), output_len=max(int(olens[i]), 1))
            for i in range(n)]
    if cfg.prefix_groups > 0:
        # drawn AFTER lengths so prefix-free workloads replay bit-for-bit
        groups = rng.integers(0, cfg.prefix_groups, n)
        for r, g in zip(reqs, groups):
            r.prefix_id = int(g)
            r.prefix_len = int(cfg.prefix_len)
            r.prompt_len += int(cfg.prefix_len)   # shared system prompt
    return reqs


def _multiturn(cfg: WorkloadConfig, arrivals, plens, olens) -> List[Request]:
    """Conversation traces: consecutive turns share an ever-growing prefix
    (the full prior history), the natural prey of a radix prefix cache."""
    n, turns = cfg.n_requests, cfg.turns
    n_conv = max((n + turns - 1) // turns, 1)
    reqs: List[Request] = []
    rid = 0
    for c in range(n_conv):
        # conversation c starts when its first request would have arrived,
        # preserving the configured offered rate in requests/s (starting
        # every conversation at arrivals[c] would multiply load by `turns`)
        at = float(arrivals[min(c * turns, n - 1)])
        history = 0
        for _ in range(turns):
            if rid >= n:
                break
            prompt = history + int(plens[rid])
            out = max(int(olens[rid]), 1)
            reqs.append(Request(
                rid=rid, arrival=at, prompt_len=prompt, output_len=out,
                prefix_id=1_000_000 + c, prefix_len=history))
            history = prompt + out
            at += max(cfg.turn_gap, 0.0)
            rid += 1
    return reqs


def fixed_batch(n: int, prompt_len: int, output_len: int) -> List[Request]:
    """The paper's Table-2 style workload: B requests, fixed lens, t=0."""
    return [Request(rid=i, arrival=0.0, prompt_len=prompt_len,
                    output_len=output_len) for i in range(n)]


def load_trace(path: str, *, n_requests: Optional[int] = None) -> List[Request]:
    """Replay a request trace from a JSONL file.

    Each line is an object with ``prompt_len`` and ``output_len`` (ints)
    and optionally ``arrival`` (seconds; missing -> 0.0).  Arrival times
    are shifted so the trace starts at its earliest arrival.
    """
    rows = []
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                rows.append((float(obj.get("arrival", 0.0)),
                             int(obj["prompt_len"]), int(obj["output_len"])))
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(
                    f"{path}:{ln + 1}: bad trace record ({e}); expected "
                    f'{{"arrival": float, "prompt_len": int, '
                    f'"output_len": int}}') from e
    if n_requests is not None:
        rows = rows[:n_requests]
    if not rows:
        raise ValueError(f"{path}: empty trace")
    t0 = min(a for a, _, _ in rows)
    return [Request(rid=i, arrival=a - t0, prompt_len=p,
                    output_len=max(o, 1))
            for i, (a, p, o) in enumerate(sorted(rows))]
