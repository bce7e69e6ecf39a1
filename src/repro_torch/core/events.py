"""Event definitions for the stage-centric simulation.

Events are the *native primitives* of Frontier's abstraction: requests flow
through a distributed system as a graph of timed events (arrival, batch
execution, KV transfer, memory signals, micro-batch pipeline stages), not as
monolithic replica-level steps.
"""
from __future__ import annotations

import enum
import itertools
from typing import Any, Callable, Dict, Optional


class EV(enum.Enum):
    # request lifecycle
    REQUEST_ARRIVAL = "request_arrival"
    PREFILL_ENQUEUE = "prefill_enqueue"
    PREFILL_COMPLETE = "prefill_complete"
    KV_TRANSFER_START = "kv_transfer_start"
    KV_TRANSFER_DONE = "kv_transfer_done"
    DECODE_ENQUEUE = "decode_enqueue"
    TOKEN_GENERATED = "token_generated"
    REQUEST_COMPLETE = "request_complete"
    # cluster-level
    BATCH_START = "batch_start"
    BATCH_DONE = "batch_done"
    MEMORY_AVAILABLE = "memory_available"
    # preemption/restore (KV swapped to host memory and back)
    SWAP_OUT_DONE = "swap_out_done"
    SWAP_IN_DONE = "swap_in_done"
    SCHEDULE_TICK = "schedule_tick"
    REPLICA_FAILURE = "replica_failure"
    REPLICA_RECOVERED = "replica_recovered"
    # AF-disaggregation micro-pipeline
    ATTN_COMPUTE_DONE = "attn_compute_done"
    A2F_TRANSFER_DONE = "a2f_transfer_done"
    FFN_COMPUTE_DONE = "ffn_compute_done"
    F2A_TRANSFER_DONE = "f2a_transfer_done"
    # expert-parallel micro-workflow (per-EP-rank dispatch/compute/combine)
    EXPERT_DISPATCH_DONE = "expert_dispatch_done"
    EXPERT_RANK_DONE = "expert_rank_done"
    EXPERT_COMBINE_DONE = "expert_combine_done"
    # shared-fabric transfers (epoch-guarded completion; stale ones no-op)
    FABRIC_TRANSFER_DONE = "fabric_transfer_done"
    # fleet control plane (multi-instance serving)
    AUTOSCALE_TICK = "autoscale_tick"
    INSTANCE_READY = "instance_ready"          # cold start finished
    POOL_RECONFIGURED = "pool_reconfigured"    # P:D rebalance weight load


_seq = itertools.count()


class Event:
    """One scheduled event.  A plain ``__slots__`` class (not a dataclass):
    the event heap is the simulator's single hottest allocation site, and a
    per-event ``__dict__`` plus dataclass ``__lt__`` dispatch dominated the
    profile at ~70k events/s.  The engine orders heap entries by a
    ``(time, seq)`` tuple key at the C level; ``__lt__`` here only backs
    direct comparisons in user code/tests.

    ``data`` is ``None`` when the event carries no payload (the common
    case) — consumers that iterate payloads use ``ev.data or {}``.
    """

    __slots__ = ("time", "seq", "kind", "fn", "data")

    def __init__(self, time: float, kind: EV = EV.SCHEDULE_TICK,
                 fn: Optional[Callable[["Event"], None]] = None,
                 data: Optional[Dict[str, Any]] = None,
                 seq: Optional[int] = None):
        self.time = time
        self.seq = next(_seq) if seq is None else seq
        self.kind = kind
        self.fn = fn
        self.data = data

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)

    def __eq__(self, other: object) -> bool:
        return self is other

    def __hash__(self) -> int:
        return id(self)

    def __repr__(self) -> str:  # compact trace line
        return f"Event(t={self.time:.6f}, {self.kind.value}, " \
               f"{self.data or {}})"
