"""Deterministic synthetic token pipeline (sharded, restartable).

The port's own copy of the reference's ``repro/training/data.py``: numpy
only, the same draws in the same order, so ``batch(step, dp_rank, dp_size)``
gives the reference's arrays byte for byte.

Generates a Zipf-distributed token stream with short-range structure (a
seeded Markov chain over a small transition table) so next-token prediction
is learnable — the loss should drop visibly over a few hundred steps, which
the end-to-end train driver and tests assert.

Determinism contract: batch(step, dp_rank) is a pure function of
(seed, step, dp_rank) — restart-safe and order-independent, the property a
fault-tolerant data loader must provide at scale.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64          # markov states


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, S = cfg.vocab_size, cfg.n_states
        # sharply peaked markov transitions; states emit zipf tokens — low
        # conditional entropy so next-token prediction is clearly learnable
        self.trans = rng.dirichlet(np.full(S, 0.05), size=S)
        ranks = np.arange(1, V + 1, dtype=np.float64)
        base = ranks ** -2.0
        self.emit = np.stack([
            np.roll(base, rng.integers(0, V)) for _ in range(S)])
        self.emit /= self.emit.sum(1, keepdims=True)
        self.trans_cum = np.cumsum(self.trans, axis=1)
        self.emit_cum = np.cumsum(self.emit, axis=1)

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b_local = cfg.global_batch // dp_size
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + dp_rank)
        T = cfg.seq_len + 1
        toks = np.empty((b_local, T), np.int32)
        s = rng.integers(0, cfg.n_states, b_local)
        for t in range(T):   # one position at a time, every row
            u_tok = rng.random((b_local, 1))
            # the reference's (emit_cum[s] < u_tok).sum(axis=1), by bisection
            # of each row (a cumulative sum ascends): the same counts, without
            # a pass over the vocabulary per token
            toks[:, t] = [np.searchsorted(self.emit_cum[i], u)
                          for i, u in zip(s, u_tok[:, 0])]
            u_s = rng.random((b_local, 1))
            s = (self.trans_cum[s] < u_s).sum(axis=1)
        np.clip(toks, 0, cfg.vocab_size - 1, out=toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
