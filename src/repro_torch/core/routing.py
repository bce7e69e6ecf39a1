"""Pluggable MoE routing modules.

A routing module produces the token-to-expert assignment map (as per-expert
token counts) for a batch — the input to the GroupedGEMM model and the
straggler max() barrier.  Implementations model different imbalance regimes;
`TraceRouting` replays counts measured from the real MoE layer
(models/moe.py surfaces them as metrics).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np


class RoutingModule:
    #: True when assign() consumes RNG draws — consumers that memoize step
    #: times use this to keep several samples per shape bucket instead of
    #: freezing a single draw.
    stochastic = True

    def assign(self, n_tokens: int, n_experts: int, top_k: int,
               rng: np.random.Generator) -> np.ndarray:
        """Return integer token counts per expert, sum == n_tokens * top_k."""
        raise NotImplementedError


class BalancedRouting(RoutingModule):
    """Perfectly load-balanced (the idealized lower bound)."""

    stochastic = False

    def assign(self, n_tokens, n_experts, top_k, rng):
        total = n_tokens * top_k
        base = total // n_experts
        counts = np.full(n_experts, base, np.int64)
        counts[: total - base * n_experts] += 1
        return counts


class UniformRouting(RoutingModule):
    """Multinomial over uniform expert probabilities (mild imbalance)."""

    _p: Optional[dict] = None   # n_experts -> probability vector (read-only)

    def assign(self, n_tokens, n_experts, top_k, rng):
        cache = self._p
        if cache is None:
            cache = self._p = {}   # lazy: subclasses need not call __init__
        p = cache.get(n_experts)
        if p is None:
            p = np.full(n_experts, 1.0 / n_experts)
            cache[n_experts] = p
        return rng.multinomial(n_tokens * top_k, p)


class ZipfRouting(RoutingModule):
    """Zipf-skewed expert popularity (hot experts; heavy stragglers)."""

    def __init__(self, alpha: float = 1.2):
        self.alpha = alpha
        self._p_base: dict = {}  # n_experts -> unshuffled rank^-alpha

    def assign(self, n_tokens, n_experts, top_k, rng):
        # assign() is the MoE hot path: the power law is deterministic per
        # n_experts, so only the shuffle + draw touch the rng per call
        base = self._p_base.get(n_experts)
        if base is None:
            ranks = np.arange(1, n_experts + 1, dtype=np.float64)
            base = ranks ** -self.alpha
            self._p_base[n_experts] = base
        p = base.copy()
        rng.shuffle(p)
        # np.add.reduce is ndarray.sum's own reduction (same pairwise
        # order, bit-identical) minus the method-dispatch wrappers
        p /= np.add.reduce(p)
        return rng.multinomial(n_tokens * top_k, p)


class TraceRouting(RoutingModule):
    """Replay expert-load distributions captured from the real MoE layer."""

    def __init__(self, fractions: Sequence[float]):
        f = np.asarray(fractions, np.float64)
        self.fractions = f / f.sum()

    def assign(self, n_tokens, n_experts, top_k, rng):
        assert len(self.fractions) == n_experts
        return rng.multinomial(n_tokens * top_k, self.fractions)


def split_by_rank(counts: np.ndarray, ep: int) -> List[np.ndarray]:
    """Partition per-expert counts into EP-rank slices (contiguous shards).

    When ``n_experts % ep != 0`` the remainder experts are spread across the
    first ranks (shard sizes differ by at most one) — no expert is dropped.
    """
    counts = np.asarray(counts)
    ep = max(int(ep), 1)
    base, rem = divmod(len(counts), ep)
    out: List[np.ndarray] = []
    off = 0
    for r in range(ep):
        n = base + (1 if r < rem else 0)
        out.append(counts[off:off + n])
        off += n
    return out


ROUTERS = {
    "balanced": BalancedRouting,
    "uniform": UniformRouting,
    "zipf": ZipfRouting,
    "trace": TraceRouting,
}


def resolve_router(spec: Union[None, str, dict, RoutingModule],
                   ) -> Optional[RoutingModule]:
    """Uniform router argument handling for every caller that builds a system.

    Accepts an instance (returned as-is), a registered name ("balanced",
    "uniform", "zipf", ...), a mapping ``{"name": ..., **kwargs}`` whose
    kwargs go to the router constructor (e.g. ``{"name": "zipf",
    "alpha": 1.4}``), or None.  Bare names construct the router with its
    default arguments; TraceRouting needs measured fractions, so it must be
    given its ``fractions`` kwarg or passed as an instance.
    """
    if spec is None or isinstance(spec, RoutingModule):
        return spec
    if isinstance(spec, str):
        spec = {"name": spec}
    if isinstance(spec, dict):
        kw = dict(spec)
        name = kw.pop("name", None)
        try:
            cls = ROUTERS[name]
        except KeyError:
            raise KeyError(
                f"unknown router {name!r}; registered: {sorted(ROUTERS)}")
        try:
            return cls(**kw)
        except TypeError as e:
            raise TypeError(
                f"router {name!r} could not be constructed from {kw!r} "
                f"({e}) — pass an instance instead of the name"
            ) from e
    raise TypeError(f"routing must be None, a name, a mapping, or a "
                    f"RoutingModule; got {type(spec).__name__}")
