"""Batch-formation policies (the serving engine's scheduler inner loop).

Modeled on vLLM/SGLang/TensorRT-LLM behaviors (paper §1 challenge 3):
- ContinuousBatching: token-budget continuous batching; prefills admitted
  whole (vLLM default).
- ChunkedPrefill: Sarathi-Serve style — prefills are split into chunks and
  piggybacked onto decode batches to bound inter-token latency.
- StaticBatching: fixed batch, run to completion (classic batching).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.request import Request, RState


@dataclass
class BatchPlan:
    prefill: List[Tuple[Request, int]]   # (request, chunk_len)
    decode: List[Request]

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode

    @property
    def q_lens(self) -> List[int]:
        return [c for _, c in self.prefill] + [1] * len(self.decode)

    @property
    def kv_lens(self) -> List[int]:
        kv = [r.prefill_progress + c for r, c in self.prefill]
        kv += [r.context_len for r in self.decode]
        return kv


class BatchingPolicy:
    name = "base"

    def plan(self, waiting: Sequence[Request], running: Sequence[Request],
             memory, now: float) -> BatchPlan:
        raise NotImplementedError


class ContinuousBatching(BatchingPolicy):
    name = "continuous"

    def __init__(self, *, max_num_seqs: int = 256,
                 max_batched_tokens: int = 8192):
        self.max_num_seqs = max_num_seqs
        self.max_batched_tokens = max_batched_tokens

    def plan(self, waiting, running, memory, now) -> BatchPlan:
        decode = [r for r in running if r.state in (RState.DECODING,
                                                    RState.QUEUED_DECODE)]
        budget = self.max_batched_tokens - len(decode)
        seqs = len(decode)
        prefill: List[Tuple[Request, int]] = []
        for r in waiting:
            if r.prefill_total - r.prefill_progress <= 0:
                continue
            # probe the prefix cache first: a hit shrinks the tokens this
            # prefill actually computes (admit_request applies it)
            hit = memory.prefix_hit(r) if memory is not None else 0
            remaining = r.prefill_total - max(r.prefill_progress, hit)
            if seqs >= self.max_num_seqs or remaining > budget:
                break  # FCFS head-of-line: vLLM admits in order
            if memory is not None and not memory.admit_request(r):
                break  # backpressure: no KV space
            remaining = r.prefill_total - r.prefill_progress
            prefill.append((r, remaining))
            budget -= remaining
            seqs += 1
        return BatchPlan(prefill, decode)


class ChunkedPrefill(BatchingPolicy):
    name = "chunked_prefill"

    def __init__(self, *, max_num_seqs: int = 256, chunk: int = 512,
                 max_batched_tokens: int = 2048):
        self.max_num_seqs = max_num_seqs
        self.chunk = chunk
        self.max_batched_tokens = max_batched_tokens

    def plan(self, waiting, running, memory, now) -> BatchPlan:
        decode = [r for r in running if r.state in (RState.DECODING,
                                                    RState.QUEUED_DECODE)]
        budget = self.max_batched_tokens - len(decode)
        seqs = len(decode)
        prefill: List[Tuple[Request, int]] = []
        # continue partially-prefilled requests first (Sarathi)
        in_flight = [r for r in waiting
                     if 0 < r.prefill_progress < r.prefill_total]
        fresh = [r for r in waiting if r.prefill_progress == 0]
        for r in in_flight + fresh:
            if budget <= 0 or seqs >= self.max_num_seqs:
                break
            if r.prefill_progress == 0 and memory is not None \
                    and not memory.admit_request(r):
                break
            # admit_request advances prefill_progress past any prefix hit
            take = min(self.chunk, r.prefill_total - r.prefill_progress,
                       budget)
            if take <= 0:
                break
            prefill.append((r, take))
            budget -= take
            seqs += 1
        return BatchPlan(prefill, decode)


class StaticBatching(BatchingPolicy):
    name = "static"

    def __init__(self, *, batch_size: int = 8):
        self.batch_size = batch_size

    def plan(self, waiting, running, memory, now) -> BatchPlan:
        decode = [r for r in running if r.state in (RState.DECODING,
                                                    RState.QUEUED_DECODE)]
        if decode:   # run the current batch to completion
            return BatchPlan([], decode)
        prefill = []
        for r in list(waiting)[: self.batch_size]:
            if memory is not None and not memory.admit_request(r):
                break
            prefill.append((r, r.prefill_total - r.prefill_progress))
        return BatchPlan(prefill, [])


BATCHING = {c.name: c for c in (ContinuousBatching, ChunkedPrefill,
                                StaticBatching)}


def resolve_batching(spec) -> Optional[BatchingPolicy]:
    """Uniform batching-policy argument handling (mirrors resolve_router).

    Accepts an instance (returned as-is), a registered name ("continuous",
    "chunked_prefill", "static"), a mapping ``{"name": ..., **kwargs}``
    whose kwargs go to the policy constructor, or None.
    """
    if spec is None or isinstance(spec, BatchingPolicy):
        return spec
    if isinstance(spec, str):
        spec = {"name": spec}
    if isinstance(spec, dict):
        kw = dict(spec)
        name = kw.pop("name", None)
        if name not in BATCHING:
            raise KeyError(f"unknown batching policy {name!r}; "
                           f"registered: {sorted(BATCHING)}")
        return BATCHING[name](**kw)
    raise TypeError(f"batching must be None, a name, a mapping, or a "
                    f"BatchingPolicy; got {type(spec).__name__}")
