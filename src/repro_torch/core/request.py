"""Request lifecycle state machine."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional


class RState(enum.Enum):
    QUEUED_PREFILL = "queued_prefill"
    PREFILL_RUNNING = "prefill_running"
    PREFILL_COMPLETE = "prefill_complete"   # KV held in prefill buffer
    KV_TRANSFER = "kv_transfer"
    QUEUED_DECODE = "queued_decode"
    DECODING = "decoding"
    PREEMPTED = "preempted"                 # KV evicted under memory pressure
    COMPLETE = "complete"


# legal transitions (property-tested)
_TRANSITIONS = {
    RState.QUEUED_PREFILL: {RState.PREFILL_RUNNING},
    RState.PREFILL_RUNNING: {RState.PREFILL_COMPLETE, RState.QUEUED_PREFILL},
    RState.PREFILL_COMPLETE: {RState.KV_TRANSFER, RState.QUEUED_DECODE,
                              RState.PREEMPTED},
    RState.KV_TRANSFER: {RState.QUEUED_DECODE},
    RState.QUEUED_DECODE: {RState.DECODING, RState.PREEMPTED},
    RState.DECODING: {RState.COMPLETE, RState.QUEUED_DECODE,
                      RState.PREEMPTED},
    # restore paths: recompute re-prefills the full context; swap-in
    # returns the request straight to the decode queue
    RState.PREEMPTED: {RState.QUEUED_PREFILL, RState.QUEUED_DECODE},
}


@dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    output_len: int
    state: RState = RState.QUEUED_PREFILL
    generated: int = 0
    prefill_progress: int = 0          # chunked-prefill bookkeeping
    # prefix sharing (set by the workload generator): requests with the
    # same prefix_id share their first prefix_len prompt tokens
    prefix_id: Optional[int] = None
    prefix_len: int = 0
    # fleet tenancy: the tenant class this request belongs to (set by the
    # fleet control plane at submission; None for single-instance runs)
    tenant: Optional[str] = None
    # preemption/restore bookkeeping
    prefill_len: Optional[int] = None  # recompute target; None -> prompt_len
    restore_pending: bool = False      # next prefill completion is a restore
    preemptions: int = 0
    # when the CURRENT prefill pass was first scheduled (reset on recompute
    # restore) — the residency anchor for streamed-KV-transfer windows;
    # "first_scheduled" in timestamps keeps the lifetime queue-delay anchor
    prefill_started: Optional[float] = None
    timestamps: Dict[str, float] = field(default_factory=dict)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    def to(self, state: RState, now: float) -> None:
        allowed = _TRANSITIONS.get(self.state, set())
        if state not in allowed:
            raise ValueError(f"illegal transition {self.state} -> {state} "
                             f"(rid={self.rid})")
        self.state = state
        self.timestamps[state.value] = now

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.generated

    @property
    def prefill_total(self) -> int:
        """Tokens this request's (next) prefill must process: the prompt,
        or the full context when restoring after a recompute preemption."""
        return self.prefill_len if self.prefill_len is not None \
            else self.prompt_len

    @property
    def done(self) -> bool:
        return self.generated >= self.output_len

    def begin_recompute(self, now: float) -> None:
        """Recompute-restore a PREEMPTED request: the KV is gone, so the
        whole current context (prompt + generated tokens) re-prefills; no
        token is re-emitted when that prefill completes."""
        self.prefill_len = self.context_len
        self.prefill_progress = 0
        self.restore_pending = True
        self.prefill_started = None
        self.to(RState.QUEUED_PREFILL, now)

    # ---- metrics -----------------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        if self.generated <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (self.generated - 1)

    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival
