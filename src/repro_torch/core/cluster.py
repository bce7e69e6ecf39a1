"""ClusterWorker / ClusterScheduler / ReplicaWorker.

A ClusterWorker is the abstraction for one specialized hardware pool (a
prefill cluster, a decode cluster, a colocated pool, an attention or FFN
cluster).  Its ClusterScheduler routes requests to ReplicaWorkers and
participates in inter-stage coordination (memory-availability signaling for
PD backpressure).  A ReplicaWorker simulates one model instance: it forms
batches with a pluggable BatchingPolicy, prices them with the
ExecutionPredictor, advances request state on BATCH_DONE events, and — when
its KVCacheManager runs out of blocks mid-decode — preempts the
lowest-priority resident requests (recompute or swap restore) instead of
silently over-committing memory.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.engine import SimEngine
from repro_torch.core.events import EV, Event
from repro_torch.core.policies.batching import BatchingPolicy, BatchPlan
from repro_torch.core.policies.memory import KVCacheManager
from repro_torch.core.policies.scheduling import FCFS, QueuePolicy
from repro_torch.core.predictor import ExecutionPredictor
from repro_torch.core.request import Request, RState


@dataclass
class Hooks:
    """Controller callbacks (inter-stage coordination points)."""
    prefill_complete: Callable = lambda r, replica: None
    token_generated: Callable = lambda r, replica, t: None
    request_complete: Callable = lambda r, replica: None
    memory_available: Callable = lambda cluster, replica: None
    preempted: Callable = lambda r, replica: None   # recompute re-routing


class ReplicaWorker:
    def __init__(self, engine: SimEngine, name: str,
                 predictor: ExecutionPredictor, policy: BatchingPolicy,
                 memory: Optional[KVCacheManager], hooks: Hooks, *,
                 role: str = "colocated", queue_policy: Optional[QueuePolicy] = None,
                 slowdown: float = 1.0, pipeline=None):
        self.engine = engine
        self.name = name
        self.predictor = predictor
        self.policy = policy
        self.memory = memory
        self.hooks = hooks
        self.role = role
        self.queue_policy = queue_policy or FCFS()
        self.pipeline = pipeline          # PipelineConfig (latency hiding)
        self.slowdown = slowdown          # straggler factor (1.0 = healthy)
        # routing eligibility: an inactive replica takes no NEW work but
        # finishes what it holds (fleet drain / P:D-rebalance standby pools);
        # distinct from `failed`, which loses in-flight work
        self.active = True
        self.waiting: List[Request] = []
        self.running: List[Request] = []  # decoding requests resident here
        self.swapped: List[Request] = []  # preempted, KV on host, awaiting room
        self._swapping_out: List[Request] = []  # swap-out transfer in flight
        self._swapping_in: List[Request] = []   # admitted, swap-in in flight
        self.busy = False
        self.failed = False
        self._epoch = 0      # bumped on failure; stale BATCH_DONEs dropped
        self.cluster: Optional["ClusterWorker"] = None
        self.stats = {"batches": 0, "busy_time": 0.0, "tokens": 0,
                      "prefill_tokens": 0}
        # observability recorder (repro_torch.obs.Telemetry); None = fully off —
        # every instrumentation site below guards on it, so untraced runs
        # execute the exact pre-observability path.  tel_name is the
        # fleet-unique identity ("<instance>/<name>") attach_telemetry
        # assigns — plain replica names repeat across fleet instances
        self.telemetry = None
        self.tel_name = name

    # ------------------------------------------------------------- intake --
    def enqueue_prefill(self, r: Request) -> None:
        self.waiting.append(r)
        self.kick()

    def start_decode(self, r: Request) -> None:
        if r.state != RState.QUEUED_DECODE:
            r.to(RState.QUEUED_DECODE, self.engine.now)
        self.running.append(r)
        self.kick()

    def kick(self) -> None:
        self.engine.after(0.0, EV.SCHEDULE_TICK, self._schedule_ev)

    def _schedule_ev(self, ev) -> None:
        self._schedule()

    # ---------------------------------------------------------- scheduling --
    def _schedule(self) -> None:
        if self.busy or self.failed:
            return
        self._try_swap_in()
        ordered = self.queue_policy.order(self.waiting, self.engine.now)
        plan = self.policy.plan(ordered, self.running, self.memory,
                                self.engine.now)
        if plan.empty:
            return
        self.busy = True
        tel = self.telemetry
        if tel is not None:
            # anchor for traced AF decode steps: inner-engine marker
            # events are step-relative, the recorder adds this base
            tel.begin_batch(self.tel_name, self.engine.now)
        piggyback = False
        if (self.pipeline is not None and self.pipeline.chunked_prefill
                and plan.prefill and plan.decode):
            # chunked prefill with piggybacked decode: the mixed batch is
            # priced as ONE fused step — prefill attention for the chunks,
            # decode attention for the piggybacked rows, shared GEMMs.
            # Deliberately gated on the pipeline flag, NOT the batch shape:
            # a bare ChunkedPrefill batching policy (no PipelineSpec) keeps
            # the legacy all-prefill pricing bit-for-bit; fused per-class
            # pricing is opt-in via PipelineSpec(chunked_prefill=True)
            bd = self.predictor.step_time(plan.q_lens, plan.kv_lens,
                                          decode=False,
                                          n_prefill=len(plan.prefill))
            self.stats["piggyback_tokens"] = (
                self.stats.get("piggyback_tokens", 0) + len(plan.decode))
            piggyback = True
        else:
            bd = self.predictor.step_time(plan.q_lens, plan.kv_lens,
                                          decode=(not plan.prefill))
        t = bd.total * self.slowdown
        self.stats["batches"] += 1
        self.stats["busy_time"] += t
        for r, _ in plan.prefill:
            if r.state == RState.QUEUED_PREFILL:
                r.to(RState.PREFILL_RUNNING, self.engine.now)
                # queueing-delay anchor: first time any replica scheduled it
                r.timestamps.setdefault("first_scheduled", self.engine.now)
                if r.prefill_started is None:   # current pass's residency
                    r.prefill_started = self.engine.now
        for r in plan.decode:
            if r.state == RState.QUEUED_DECODE:
                r.to(RState.DECODING, self.engine.now)
        if tel is not None:
            now = self.engine.now
            for r, chunk in plan.prefill:
                # progress is pre-chunk: a cache hit shows up as a
                # nonzero first-chunk progress (prefix tokens skipped)
                tel.span("prefill_chunk", r.rid, now, now + t,
                         replica=self.tel_name, chunk=chunk,
                         progress=r.prefill_progress,
                         total=r.prefill_total, piggyback=piggyback)
            for r in plan.decode:
                tel.compute_span("decode", r.rid, now, now + t,
                                 self.tel_name)
            tel.counter(f"batch_occupancy/{self.name}", now,
                        len(plan.prefill) + len(plan.decode),
                        replica=self.tel_name)
            if self.memory is not None:
                tel.counter(f"kv_used_blocks/{self.name}", now,
                            self.memory.total_blocks
                            - self.memory.free_blocks,
                            replica=self.tel_name)
                tel.counter(f"kv_cached_blocks/{self.name}", now,
                            self.memory.cached_blocks(),
                            replica=self.tel_name)
            straggle = bd.parts.get("ep_straggler_excess")
            if straggle is not None:
                tel.counter(f"ep_straggler_excess_s/{self.name}", now,
                            straggle, replica=self.tel_name)
        self.engine.after(t, EV.BATCH_DONE,
                          lambda ev, epoch=self._epoch:
                          self._batch_done(plan, epoch),
                          replica=self.name, dur=t,
                          n_prefill=len(plan.prefill), n_decode=len(plan.decode))

    def _batch_done(self, plan: BatchPlan, epoch: int = -1) -> None:
        if epoch != -1 and epoch != self._epoch:
            # the replica failed while this batch was in flight: its work is
            # lost and its requests were re-routed — drop the stale event
            return
        now = self.engine.now
        self.busy = False
        freed = False
        for r, chunk in plan.prefill:
            r.prefill_progress += chunk
            self.stats["prefill_tokens"] += chunk
            if r.prefill_progress >= r.prefill_total:
                self.waiting.remove(r)
                r.to(RState.PREFILL_COMPLETE, now)
                if r.restore_pending:
                    # recompute restore: the context (incl. every generated
                    # token) is rebuilt — no new token is emitted
                    r.restore_pending = False
                else:
                    # prefill emits the first token
                    r.generated += 1
                    self.stats["tokens"] += 1
                    if r.first_token_time is None:
                        r.first_token_time = now
                    self.hooks.token_generated(r, self, now)
                if self.role == "colocated":
                    if (self.memory is not None
                            and not self.memory.grow(r.rid, r.context_len)
                            and not self._resolve_oom(r)):
                        continue   # r was preempted; restore path owns it
                    r.to(RState.QUEUED_DECODE, now)
                    self.running.append(r)
                else:
                    self.hooks.prefill_complete(r, self)
            else:
                r.to(RState.QUEUED_PREFILL, now)  # chunked: back to queue
        for r in plan.decode:
            if r.state not in (RState.DECODING, RState.QUEUED_DECODE):
                continue   # evicted by an earlier OOM this step (already
                           # PREEMPTED, or re-queued for recompute); its
                           # token is discarded and recomputed on restore
            r.generated += 1
            self.stats["tokens"] += 1
            self.hooks.token_generated(r, self, now)
            if r.done:
                self.running.remove(r)
                r.to(RState.COMPLETE, now)
                r.finish_time = now
                if self.memory is not None:
                    self.memory.free(r.rid)
                    freed = True
                self.hooks.request_complete(r, self)
                continue
            if (self.memory is not None
                    and not self.memory.grow(r.rid, r.context_len)):
                self._resolve_oom(r)
        if freed:
            self._try_swap_in()
            self.hooks.memory_available(self.cluster, self)
        self.kick()

    # ----------------------------------------------------------- preemption --
    def _pick_victim(self, exclude: Request) -> Optional[Request]:
        """Lowest-priority resident: the latest-arrived decoding request
        (vLLM's preemption order), never the one we are growing."""
        candidates = [v for v in self.running
                      if v is not exclude
                      and v.state in (RState.DECODING, RState.QUEUED_DECODE)]
        if not candidates:
            return None
        return max(candidates, key=lambda v: (v.arrival, v.rid))

    def _resolve_oom(self, r: Request) -> bool:
        """Decode OOM: evict lowest-priority residents until r's KV fits.

        Returns True when r keeps its residency; False when r itself had
        to be preempted (no other victim remained and even the watermark
        reserve could not absorb the growth).
        """
        while not self.memory.grow(r.rid, r.context_len):
            victim = self._pick_victim(exclude=r)
            if victim is None:
                # r is the only resident: dip into the reserve before
                # giving up — preempting it could never make progress
                if self.memory.grow(r.rid, r.context_len,
                                    ignore_watermark=True):
                    return True
                self._preempt(r)
                return False
            self._preempt(victim)
        return True

    def _preempt(self, r: Request) -> None:
        now = self.engine.now
        if self.memory.blocks_for(r.prompt_len + r.output_len) \
                > self.memory.total_blocks:
            # restoring could never succeed: the request's maximum context
            # exceeds the whole pool — fail loudly instead of cycling
            # preempt/readmit forever or silently stranding the request
            raise RuntimeError(
                f"replica {self.name}: request {r.rid} needs "
                f"{self.memory.blocks_for(r.prompt_len + r.output_len)} KV "
                f"blocks for its full context but the pool has only "
                f"{self.memory.total_blocks}; raise memory capacity "
                f"(capacity_frac) or shorten the workload")
        swap = self.memory.preemption == "swap"
        if r in self.running:
            self.running.remove(r)
        # recompute drops the KV; only the declared shared prefix stays
        # resident (ref-counted cache, full_extent=False).  A swap moves
        # the WHOLE KV to host, so the device must not also fold it into
        # the prefix cache (that would hold the same bytes twice once
        # swap-in re-reserves them)
        self.memory.free(r.rid, insert=not swap, full_extent=False)
        r.to(RState.PREEMPTED, now)
        r.preemptions += 1
        self.stats["preemptions"] = self.stats.get("preemptions", 0) + 1
        if self.telemetry is not None:
            self.telemetry.span("preempt", r.rid, now, now,
                                replica=self.tel_name,
                                mode="swap" if swap else "recompute")
        if swap:
            dt = self.memory.swap_time(r.context_len)
            self.stats["swap_outs"] = self.stats.get("swap_outs", 0) + 1
            self.stats["swap_time_s"] = \
                self.stats.get("swap_time_s", 0.0) + dt
            self._swapping_out.append(r)
            if self.telemetry is not None:
                self.telemetry.span("swap_out", r.rid, now, now + dt,
                                    replica=self.tel_name,
                                    tokens=r.context_len)
            self.engine.after(dt, EV.SWAP_OUT_DONE,
                              lambda ev, r=r, epoch=self._epoch:
                              self._swap_out_done(r, epoch),
                              rid=r.rid, replica=self.name)
        else:  # recompute: KV is gone; re-prefill through an entry cluster
            r.begin_recompute(now)
            self.hooks.preempted(r, self)

    def _swap_out_done(self, r: Request, epoch: int) -> None:
        if epoch != self._epoch:
            return   # replica failed mid-swap; fail() re-routed the request
        self._swapping_out.remove(r)
        self.swapped.append(r)
        self._try_swap_in()

    def _try_swap_in(self) -> None:
        """Restore swapped-out requests (oldest first) as memory allows."""
        if not self.swapped or self.memory is None:
            return
        still: List[Request] = []
        for r in sorted(self.swapped, key=lambda r: (r.arrival, r.rid)):
            if self.memory.admit(r.rid, r.context_len,
                                 max_tokens=r.prompt_len + r.output_len):
                dt = self.memory.swap_time(r.context_len)
                self.stats["swap_ins"] = self.stats.get("swap_ins", 0) + 1
                self.stats["swap_time_s"] = \
                    self.stats.get("swap_time_s", 0.0) + dt
                self._swapping_in.append(r)
                if self.telemetry is not None:
                    self.telemetry.span(
                        "swap_in", r.rid, self.engine.now,
                        self.engine.now + dt, replica=self.tel_name,
                        tokens=r.context_len)
                self.engine.after(dt, EV.SWAP_IN_DONE,
                                  lambda ev, r=r, epoch=self._epoch:
                                  self._swap_in_done(r, epoch),
                                  rid=r.rid, replica=self.name)
            else:
                still.append(r)
        self.swapped = still

    def _swap_in_done(self, r: Request, epoch: int) -> None:
        if epoch != self._epoch:
            return
        self._swapping_in.remove(r)
        r.to(RState.QUEUED_DECODE, self.engine.now)
        self.running.append(r)
        self.kick()

    # ------------------------------------------------------------ failures --
    def fail(self, downtime: float) -> List[Request]:
        """Replica failure: running work is lost and must be re-routed."""
        self.failed = True
        self._epoch += 1      # invalidate any in-flight BATCH_DONE/swap
        self.busy = False
        lost = (self.waiting + self.running + self.swapped
                + self._swapping_out + self._swapping_in)
        self.waiting, self.running = [], []
        self.swapped, self._swapping_out, self._swapping_in = [], [], []
        if self.memory is not None:
            for r in lost:
                self.memory.free(r.rid, insert=False)
        self.engine.after(downtime, EV.REPLICA_RECOVERED,
                          lambda ev: self._recover(), replica=self.name)
        return lost

    def _recover(self) -> None:
        self.failed = False
        self.kick()

    # -------------------------------------------------------------- state --
    def load(self) -> float:
        mem = self.memory.utilization if self.memory is not None else 0.0
        return len(self.waiting) + len(self.running) + mem


class ClusterWorker:
    """A pool of replicas with a cluster-level scheduler."""

    def __init__(self, name: str, role: str, replicas: List[ReplicaWorker]):
        self.name = name
        self.role = role
        self.replicas = replicas
        for r in replicas:
            r.cluster = self

    # -- ClusterScheduler duties -------------------------------------------
    def route(self, r: Request) -> ReplicaWorker:
        healthy = [w for w in self.replicas if not w.failed and w.active]
        if not healthy:
            raise RuntimeError(f"cluster {self.name}: no healthy replicas")
        w = min(healthy, key=lambda w: (w.load(), w.name))
        return w

    def replica_with_memory(self, r: Request) -> Optional[ReplicaWorker]:
        """For pull-based KV transfer: who can host this request's KV?"""
        best, best_load = None, None
        for w in self.replicas:
            if w.failed or not w.active or w.memory is None:
                continue
            if w.memory.can_admit(r.context_len,
                                  max_tokens=r.prompt_len + r.output_len):
                l = w.load()
                if best is None or l < best_load:
                    best, best_load = w, l
        return best

    def active_replicas(self) -> List[ReplicaWorker]:
        return [w for w in self.replicas if w.active and not w.failed]

    def queue_depth(self) -> int:
        """Outstanding work resident in this pool (waiting + running)."""
        return sum(len(w.waiting) + len(w.running) for w in self.replicas)

    def utilization(self, now: float) -> float:
        if not self.replicas or now <= 0:
            return 0.0
        return sum(w.stats["busy_time"] for w in self.replicas) / (
            now * len(self.replicas))
