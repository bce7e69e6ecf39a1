"""GlobalController: the stateful orchestrator of inter-stage workflows.

Implements the paper's §3.3 PD-disaggregation workflow verbatim:
(1) prefill stage as producer — requests routed to the prefill cluster,
    PREFILL_COMPLETE transitions tracked, KV held in the prefill buffer;
(2) decode stage as consumer with finite KV memory — its ClusterScheduler
    signals MEMORY_AVAILABLE on evictions;
(3) the controller respects backpressure: it keeps a PREFILL_COMPLETE queue
    and initiates KV_CACHE_TRANSFER only when a decode replica has space.
Colocated mode degenerates to routing + tracking.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.cluster import ClusterWorker, Hooks, ReplicaWorker
from repro_torch.core.engine import SimEngine
from repro_torch.core.events import EV
from repro_torch.core.hardware import LinkSpec
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.policies.memory import KVTransferPlan
from repro_torch.core.request import Request, RState


class GlobalController:
    def __init__(self, engine: SimEngine, *,
                 mode: str = "colocated",
                 clusters: Dict[str, ClusterWorker],
                 kv_bytes_per_token: float = 0.0,
                 transfer_bw: float = 25e9,
                 metrics: Optional[MetricsCollector] = None,
                 links: Optional[Dict[Tuple[str, str], LinkSpec]] = None,
                 entry: Optional[List[str]] = None,
                 kv_layers: int = 1,
                 transfer_overlap: float = 0.0,
                 fabric=None):
        self.engine = engine
        self.mode = mode
        self.clusters = clusters
        self.kv_bytes_per_token = kv_bytes_per_token
        self.transfer_bw = transfer_bw
        self.metrics = metrics or MetricsCollector()
        # inter-cluster link table (asymmetric: keyed on (src, dst)); a
        # missing entry falls back to the flat transfer_bw
        self.links = links or {}
        # entry cluster names for arrivals; None -> legacy mode-based lookup
        self.entry = entry
        # layer-wise streamed KV transfer: per-layer chunks pipeline behind
        # remaining prefill compute; overlap=0 keeps the legacy lump-sum
        # pricing bit-for-bit
        self.kv_layers = max(kv_layers, 1)
        self.transfer_overlap = transfer_overlap
        # shared-fabric contention model (core.fabric.Fabric); None keeps
        # the legacy isolated point-to-point transfer pricing
        self.fabric = fabric
        self.transfer_stats = {"transfers": 0, "bytes": 0.0,
                               "serial_s": 0.0, "exposed_s": 0.0}
        self.pending_transfer: List[Request] = []   # PREFILL_COMPLETE queue
        self.prefill_home: Dict[int, ReplicaWorker] = {}
        self.requests: Dict[int, Request] = {}
        self._transfers_in_flight = 0
        self._closed_queue: Deque[Request] = deque()  # closed-loop backlog
        # instance-ification hooks: a fleet control plane treats this
        # controller as ONE serving instance among many.  ``observer`` is
        # called on every request completion (drain tracking / fleet
        # metrics); ``completed_count`` backs the outstanding() load signal
        # global routers read.
        self.observer: Optional[Callable[[Request, ReplicaWorker], None]] = None
        self.completed_count = 0
        # observability recorder (repro_torch.obs.Telemetry); None = fully off
        self.telemetry = None
        self.tel_instance = ""      # fleet instance label for span identity

    # ------------------------------------------------------------- wiring --
    def hooks(self) -> Hooks:
        return Hooks(
            prefill_complete=self.on_prefill_complete,
            token_generated=self.metrics.on_token,
            request_complete=self.on_request_complete,
            memory_available=self.on_memory_available,
            preempted=self.on_preempted,
        )

    # ------------------------------------------------------------ arrivals --
    def _submit_one(self, r: Request, at: float) -> None:
        r.arrival = at
        self.requests[r.rid] = r
        self.engine.at(at, EV.REQUEST_ARRIVAL,
                       lambda ev, r=r: self._arrive(r), rid=r.rid)

    def submit_all(self, requests: List[Request]) -> None:
        arr = [r.arrival for r in requests]
        if any(a > b for a, b in zip(arr, arr[1:])):
            for r in requests:            # unsorted: per-event heap path
                self._submit_one(r, r.arrival)
            return
        # sorted arrival streams (every open-loop generator) go through the
        # engine's bulk timeline: no heap traffic, no per-arrival closure,
        # and Event objects materialize lazily at dispatch.  Sequence
        # numbers are assigned here in request order, so tie-breaking is
        # bit-identical to the per-event path.
        for r in requests:
            self.requests[r.rid] = r
        self.engine.schedule_timeline(
            (r.arrival, EV.REQUEST_ARRIVAL, self._arrive_ev, r)
            for r in requests)

    def _arrive_ev(self, ev) -> None:
        self._arrive(ev.data)

    def submit_closed(self, requests: List[Request], concurrency: int) -> None:
        """Closed-loop injection: keep at most ``concurrency`` requests in
        flight; a new request arrives the moment a slot frees (its arrival
        timestamp is re-stamped to the completion time that freed it)."""
        if concurrency < 1:
            raise ValueError(f"closed-loop concurrency must be >= 1, "
                             f"got {concurrency}")
        self._closed_queue.extend(requests)
        for _ in range(min(concurrency, len(self._closed_queue))):
            self._submit_one(self._closed_queue.popleft(), at=self.engine.now)

    def _entry_clusters(self) -> List[ClusterWorker]:
        if self.entry:
            return [self.clusters[n] for n in self.entry]
        return [self.clusters["prefill" if self.mode == "pd" else "colocated"]]

    def _decode_clusters(self) -> List[ClusterWorker]:
        return [c for c in self.clusters.values() if c.role == "decode"]

    def _arrive(self, r: Request) -> None:
        # anchor the measurement window to the first actual arrival (a late
        # first request must not inflate the measured duration)
        if self.metrics.start is None:
            self.metrics.start = self.engine.now
        # least-loaded healthy replica across all entry clusters
        candidates = []
        for cluster in self._entry_clusters():
            try:
                candidates.append(cluster.route(r))
            except RuntimeError:
                continue
        if not candidates:
            raise RuntimeError("no healthy entry replicas")
        replica = min(candidates, key=lambda w: (w.load(), w.name))
        replica.enqueue_prefill(r)

    # -------------------------------------------------- PD stage handoffs --
    def on_prefill_complete(self, r: Request, replica: ReplicaWorker) -> None:
        if self.mode != "pd":
            return
        # KV stays in the prefill replica's buffer until transferred.
        self.prefill_home[r.rid] = replica
        self.pending_transfer.append(r)
        self._try_transfers()

    def on_memory_available(self, cluster: Optional[ClusterWorker],
                            replica: ReplicaWorker) -> None:
        if self.mode == "pd" and cluster is not None and cluster.role == "decode":
            self._try_transfers()

    def _transfer_time(self, src: Optional[str], dst: str,
                       nbytes: float) -> float:
        link = self.links.get((src, dst)) if src is not None else None
        if link is not None:
            return link.transfer_time(nbytes)
        return nbytes / self.transfer_bw if self.transfer_bw else 0.0

    def _transfer_exposed(self, src: Optional[str], dst: str,
                          nbytes: float, r: Request) -> Tuple[float, float]:
        """Price one KV transfer: (exposed_time, serial_time).

        With ``transfer_overlap > 0`` the KV streams layer-by-layer over
        the link during the producing prefill's residency window, so only
        the un-hidden tail is exposed; overlap=0 takes the legacy lump-sum
        path verbatim (identical event timing, serial == exposed).
        """
        if self.transfer_overlap <= 0.0 or self.kv_layers <= 1:
            dt = self._transfer_time(src, dst, nbytes)
            return dt, dt
        link = self.links.get((src, dst)) if src is not None else None
        bw = link.bandwidth if link is not None else self.transfer_bw
        lat = link.latency if link is not None else 0.0
        plan = KVTransferPlan(
            n_layers=self.kv_layers,
            bytes_per_layer=nbytes / self.kv_layers,
            bandwidth=bw, latency=lat, overlap=self.transfer_overlap)
        # the streaming window is the CURRENT prefill pass's compute span
        # only: first schedule -> prefill completion.  Neither a recompute-
        # restored request's earlier lifetime nor time spent backpressured
        # in pending_transfer can hide bytes — no decode target held memory
        # for the chunks to stream into during the wait.
        done = r.timestamps.get("prefill_complete", self.engine.now)
        start = r.prefill_started if r.prefill_started is not None else done
        return plan.exposed_time(done - start), plan.serial_time

    def _try_transfers(self) -> None:
        """Initiate KV transfers for as many queued requests as decode
        memory allows (system-level backpressure).  With multiple decode
        pools, the least-loaded pool with free memory wins; the transfer is
        priced on the (prefill cluster -> decode cluster) link when one is
        declared, else the flat transfer_bw."""
        if self.mode != "pd":
            return
        decode_pools = self._decode_clusters()
        remaining: List[Request] = []
        for r in self.pending_transfer:
            target, target_cluster = None, None
            best_load = None
            for pool in decode_pools:
                w = pool.replica_with_memory(r)
                if w is None:
                    continue
                l = w.load()
                if best_load is None or l < best_load:
                    target, target_cluster, best_load = w, pool, l
            if target is None:
                remaining.append(r)        # backpressured
                continue
            admitted = target.memory.admit(
                r.rid, r.context_len,
                max_tokens=r.prompt_len + r.output_len)
            assert admitted
            r.to(RState.KV_TRANSFER, self.engine.now)
            # everything the prefill pass (re)built crosses the link: the
            # prompt's KV, or the full restored context after a recompute
            # preemption (prefill_total == prompt_len for fresh requests)
            nbytes = self.kv_bytes_per_token * r.prefill_total
            src = self.prefill_home.get(r.rid)
            src_name = src.cluster.name if src is not None and src.cluster \
                else None
            dt, serial = self._transfer_exposed(
                src_name, target_cluster.name, nbytes, r)
            self.transfer_stats["transfers"] += 1
            self.transfer_stats["bytes"] += nbytes
            self.transfer_stats["serial_s"] += serial
            self._transfers_in_flight += 1
            if self.fabric is not None:
                # contention-priced path: the point-to-point time above is
                # only the uncontended floor (serial_s); actual completion
                # and exposed_s come from the fabric's processor-sharing
                # re-pricing
                link = self.links.get((src_name, target_cluster.name)) \
                    if src_name is not None else None
                cap = link.bandwidth if link is not None \
                    else (self.transfer_bw or None)
                lat = link.latency if link is not None else 0.0
                t0 = self.engine.now
                self.fabric.start_transfer(
                    src_name, target_cluster.name, nbytes, cap=cap,
                    latency=lat,
                    done=lambda r=r, tgt=target, t0=t0, serial=serial,
                    nb=nbytes: self._fabric_transfer_done(r, tgt, t0,
                                                          serial, nb))
            else:
                self.transfer_stats["exposed_s"] += dt
                if self.telemetry is not None:
                    now = self.engine.now
                    self.telemetry.span(
                        "kv_transfer", r.rid, now, now + dt,
                        replica=target.tel_name, bytes=nbytes,
                        exposed_s=dt, serial_s=serial,
                        hidden_s=max(serial - dt, 0.0))
                self.engine.after(
                    dt, EV.KV_TRANSFER_DONE,
                    lambda ev, r=r, tgt=target: self._transfer_done(r, tgt),
                    rid=r.rid, bytes=nbytes)
        self.pending_transfer = remaining

    def _fabric_transfer_done(self, r: Request, target: ReplicaWorker,
                              t0: float, serial: float = 0.0,
                              nbytes: float = 0.0) -> None:
        self.transfer_stats["exposed_s"] += self.engine.now - t0
        if self.telemetry is not None:
            # under contention the uncontended point-to-point time is the
            # floor (serial_s); the span's extent is actual occupancy
            self.telemetry.span(
                "kv_transfer", r.rid, t0, self.engine.now,
                replica=target.tel_name, bytes=nbytes,
                exposed_s=self.engine.now - t0, serial_s=serial,
                contended=True)
        self._transfer_done(r, target)

    def _transfer_done(self, r: Request, target: ReplicaWorker) -> None:
        self._transfers_in_flight -= 1
        src = self.prefill_home.pop(r.rid, None)
        if src is not None and src.memory is not None:
            src.memory.free(r.rid)
            src.kick()                      # prefill can admit more work
        target.start_decode(r)

    # ---------------------------------------------------------- preemption --
    def on_preempted(self, r: Request, replica: ReplicaWorker) -> None:
        """Recompute restore: the request re-enters prefill at the least
        loaded entry cluster (its KV is gone; swap restores stay local to
        the replica and never reach this hook)."""
        if self.telemetry is not None:
            self.telemetry.span("recompute_requeue", r.rid,
                                self.engine.now, self.engine.now,
                                replica=replica.tel_name)
        self._arrive(r)

    # ------------------------------------------------------------- endings --
    def on_request_complete(self, r: Request, replica: ReplicaWorker) -> None:
        self.metrics.on_complete(r, replica)
        self.completed_count += 1
        if self.telemetry is not None:
            self.telemetry.end_request(r, instance=self.tel_instance)
        if self.observer is not None:
            self.observer(r, replica)
        if self._closed_queue:      # closed loop: a slot just freed
            self._submit_one(self._closed_queue.popleft(), at=self.engine.now)

    # --------------------------------------------------- instance surface --
    def outstanding(self) -> int:
        """Requests submitted to this instance and not yet complete — the
        load signal global (fleet-level) routers balance on."""
        return len(self.requests) - self.completed_count

    def pool_depths(self) -> Dict[str, int]:
        """Per-role outstanding work (P:D pressure signal for rebalancing)."""
        depths: Dict[str, int] = {}
        for c in self.clusters.values():
            depths[c.role] = depths.get(c.role, 0) + c.queue_depth()
        return depths

    def prefix_probe(self, r: Request) -> int:
        """Best cached-prefix hit (tokens) any entry replica would give this
        request right now — the affinity signal for cache-aware routing."""
        best = 0
        for cluster in self._entry_clusters():
            for w in cluster.replicas:
                # inactive replicas' caches are unreachable for new work
                # (drained donor / standby pools) — never advertise them
                if w.failed or not w.active or w.memory is None:
                    continue
                best = max(best, w.memory.prefix_hit(r))
        return best

    # ------------------------------------------------------------ failures --
    def inject_failure(self, cluster_name: str, replica_idx: int,
                       at: float, downtime: float) -> None:
        cluster = self.clusters[cluster_name]
        replica = cluster.replicas[replica_idx]

        def do_fail(ev):
            lost = replica.fail(downtime)
            # re-route lost work to healthy replicas (restart from scratch:
            # conservative fault model — KV is gone)
            for r in lost:
                if r.state in (RState.QUEUED_PREFILL, RState.PREFILL_RUNNING):
                    r.state = RState.QUEUED_PREFILL
                    cluster.route(r).enqueue_prefill(r)
                elif r.state in (RState.DECODING, RState.QUEUED_DECODE,
                                 RState.PREEMPTED):
                    r.state = RState.QUEUED_PREFILL
                    r.prefill_progress = 0
                    r.generated = 0
                    r.prefill_len = None
                    r.restore_pending = False
                    r.prefill_started = None
                    self._arrive(r)
        self.engine.at(at, EV.REPLICA_FAILURE, do_fail,
                       cluster=cluster_name, replica=replica_idx)

    # ------------------------------------------------------------- invariant --
    def conservation_check(self) -> Dict[str, int]:
        """Every submitted request is exactly in one place (property test)."""
        states = {}
        for r in self.requests.values():
            states[r.state.value] = states.get(r.state.value, 0) + 1
        return states
