"""Shared network fabric: contention pricing for inter-cluster traffic.

Until now every inter-cluster byte was priced on an isolated point-to-point
``LinkSpec`` (or the flat ``inter_node_bw``): two transfers into the same
decode pool never contended, and a collective's cost ignored the topology
it ran over.  This module adds the missing shared medium:

- ``Fabric`` — the runtime object.  Each cluster attaches a per-NIC uplink
  into the fabric; concurrent transfers sharing an uplink split its
  effective bandwidth processor-sharing style and are *re-priced* at every
  transfer start/finish event in the engine (epoch-guarded rescheduling —
  the event heap has no cancel).  A flow's instantaneous rate is

      min(per-flow link cap,
          tx_uplink / oversubscription / n_active_tx,
          rx_uplink / oversubscription / n_active_rx)

  which is deliberately *not* max-min fair (a capped flow's unused share is
  not redistributed): the math stays hand-computable and monotone — adding
  a concurrent flow or raising oversubscription never speeds anything up.

- ``FabricOps`` — an OperatorModelSet wrapper that re-prices the
  *inter-node* collectives topology-aware over the fabric (ring/tree
  all-reduce with per-hop latency, pairwise all-to-all, and the
  MegaScale-style M2N dispatch/combine) while delegating all compute
  operators to the wrapped model set, so refined/calibrated operator
  models keep working unchanged.

``fabric: none`` (the default everywhere) never constructs either object —
existing reports stay bit-identical.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.engine import SimEngine
from repro_torch.core.events import EV
from repro_torch.core.opmodels.analytical import OperatorModelSet

COLLECTIVES = ("ring", "tree")
FABRIC_MODES = ("none", "shared")


@dataclass(frozen=True)
class FabricConfig:
    """Resolved fabric parameters (built from ``api.spec.FabricSpec``)."""
    mode: str = "none"              # "none" | "shared"
    oversubscription: float = 1.0   # uplink sharing factor (>= 1 physical)
    latency_s: float = 0.0          # per-hop fabric latency
    collective: str = "ring"        # inter-node all-reduce algorithm
    # per-NIC uplink into the fabric; None -> each cluster's inter_node_bw
    uplink_bw: Optional[float] = None

    def validate(self) -> None:
        if self.mode not in FABRIC_MODES:
            raise ValueError(f"fabric mode must be one of {FABRIC_MODES}, "
                             f"got {self.mode!r}")
        if self.oversubscription <= 0:
            raise ValueError(f"fabric oversubscription must be > 0, got "
                             f"{self.oversubscription}")
        if self.latency_s < 0:
            raise ValueError(f"fabric latency_s must be >= 0, got "
                             f"{self.latency_s}")
        if self.collective not in COLLECTIVES:
            raise ValueError(f"fabric collective must be one of "
                             f"{COLLECTIVES}, got {self.collective!r}")
        if self.uplink_bw is not None and self.uplink_bw <= 0:
            raise ValueError(f"fabric uplink_bw must be > 0, got "
                             f"{self.uplink_bw}")


class _Flow:
    __slots__ = ("src", "dst", "remaining", "cap", "rate", "epoch",
                 "done", "t_submit", "nbytes")

    def __init__(self, src: Optional[str], dst: Optional[str],
                 nbytes: float, cap: Optional[float],
                 done: Optional[Callable[[], None]], t_submit: float):
        self.src = src
        self.dst = dst
        self.nbytes = nbytes
        self.remaining = nbytes
        self.cap = cap
        self.rate = 0.0
        self.epoch = 0
        self.done = done
        self.t_submit = t_submit


class Fabric:
    """Processor-sharing contention on per-cluster uplinks.

    Clusters ``attach`` an uplink capacity; ``start_transfer`` runs a flow
    through (latency phase, then the shared-bandwidth phase).  All active
    flows are drained and re-priced whenever one joins or finishes; stale
    completion events are recognized by a per-flow epoch counter and
    ignored (the engine's heap is append-only).
    """

    def __init__(self, engine: SimEngine, config: FabricConfig):
        config.validate()
        self.engine = engine
        self.config = config
        self._uplinks: Dict[str, float] = {}     # cluster -> capacity (B/s)
        self._flows: List[_Flow] = []            # active bandwidth-phase flows
        self._t_last = 0.0                       # last drain timestamp
        self.stats = {"transfers": 0, "bytes": 0.0,
                      "uncontended_s": 0.0, "actual_s": 0.0,
                      "collective_s": 0.0, "collective_uncontended_s": 0.0}
        # observability recorder (repro_torch.obs.Telemetry); None = fully off
        self.telemetry = None

    # ------------------------------------------------------------ topology --
    def attach(self, cluster: str, uplink_bw: float) -> None:
        """Attach a cluster's NIC uplink; effective capacity is the raw
        uplink divided by the configured oversubscription factor."""
        bw = self.config.uplink_bw if self.config.uplink_bw is not None \
            else uplink_bw
        if bw <= 0:
            raise ValueError(f"fabric uplink for cluster {cluster!r} must "
                             f"be > 0, got {bw}")
        self._uplinks[cluster] = bw / self.config.oversubscription

    def capacity(self, cluster: Optional[str]) -> float:
        """Effective uplink capacity; unattached/unknown ends (e.g. an
        external KV source) are unconstrained."""
        if cluster is None:
            return math.inf
        return self._uplinks.get(cluster, math.inf)

    # ------------------------------------------------------------ transfers --
    def start_transfer(self, src: Optional[str], dst: Optional[str],
                       nbytes: float, *, cap: Optional[float] = None,
                       latency: float = 0.0,
                       done: Optional[Callable[[], None]] = None) -> None:
        """Run one transfer over the fabric and call ``done()`` at its
        (contention-dependent) completion time.  ``cap`` is the per-flow
        point-to-point link ceiling; ``latency`` the link's base latency,
        paid (together with the fabric hop latency) before the flow enters
        the shared-bandwidth phase."""
        now = self.engine.now
        flow = _Flow(src, dst, max(nbytes, 0.0), cap, done, now)
        self.stats["transfers"] += 1
        self.stats["bytes"] += flow.nbytes
        solo = self._solo_rate(flow)
        lat = latency + self.config.latency_s
        self.stats["uncontended_s"] += lat + (
            flow.nbytes / solo if solo < math.inf else 0.0)
        if lat > 0.0:
            self.engine.after(lat, EV.KV_TRANSFER_START,
                              lambda ev, f=flow: self._join(f))
        else:
            self._join(flow)

    def _solo_rate(self, flow: _Flow) -> float:
        r = min(self.capacity(flow.src), self.capacity(flow.dst))
        if flow.cap is not None:
            r = min(r, flow.cap)
        return r

    def _join(self, flow: _Flow) -> None:
        self._drain()
        if flow.remaining <= 0.0 or self._solo_rate(flow) == math.inf:
            # zero-byte or fully unconstrained: completes immediately
            self._finish(flow)
            self._reprice()
            return
        self._flows.append(flow)
        self._reprice()

    def _drain(self) -> None:
        """Advance all active flows' progress to ``engine.now`` at their
        current rates."""
        now = self.engine.now
        dt = now - self._t_last
        if dt > 0.0:
            for f in self._flows:
                f.remaining -= f.rate * dt
        self._t_last = now

    def _reprice(self) -> None:
        """Recompute every active flow's processor-sharing rate and
        (re)schedule its completion; prior completion events go stale via
        the epoch bump."""
        n_tx: Dict[str, int] = {}
        n_rx: Dict[str, int] = {}
        for f in self._flows:
            if f.src is not None:
                n_tx[f.src] = n_tx.get(f.src, 0) + 1
            if f.dst is not None:
                n_rx[f.dst] = n_rx.get(f.dst, 0) + 1
        for f in self._flows:
            rate = min(self.capacity(f.src) / n_tx.get(f.src, 1)
                       if f.src is not None else math.inf,
                       self.capacity(f.dst) / n_rx.get(f.dst, 1)
                       if f.dst is not None else math.inf)
            if f.cap is not None:
                rate = min(rate, f.cap)
            f.rate = rate
            f.epoch += 1
            eta = f.remaining / rate if rate > 0.0 else math.inf
            if eta < math.inf:
                self.engine.after(
                    eta, EV.FABRIC_TRANSFER_DONE,
                    lambda ev, ff=f, ep=f.epoch: self._maybe_finish(ff, ep))
        if self.telemetry is not None:
            # sampled at every repricing event: per-uplink concurrent
            # flows and the resulting effective per-flow bandwidth
            now = self.engine.now
            for cl, n in sorted(n_tx.items()):
                self.telemetry.counter(f"fabric_tx_flows/{cl}", now, n)
                cap = self.capacity(cl)
                if cap < math.inf:
                    self.telemetry.counter(
                        f"fabric_tx_eff_bw_gbps/{cl}", now,
                        cap / max(n, 1) / 1e9)
            for cl, n in sorted(n_rx.items()):
                self.telemetry.counter(f"fabric_rx_flows/{cl}", now, n)
            self.telemetry.counter("fabric_in_flight", now,
                                   len(self._flows))

    def _maybe_finish(self, flow: _Flow, epoch: int) -> None:
        if flow.epoch != epoch or flow not in self._flows:
            return                      # stale completion event: re-priced
        # epoch match => no re-price happened since this completion was
        # scheduled, so the flow ran at a constant rate for exactly its
        # remaining/rate — it is done (modulo float residue)
        self._drain()
        flow.remaining = 0.0
        self._flows.remove(flow)
        self._finish(flow)
        self._reprice()

    def _finish(self, flow: _Flow) -> None:
        self.stats["actual_s"] += self.engine.now - flow.t_submit
        if flow.done is not None:
            flow.done()

    # ------------------------------------------------------------ reporting --
    def in_flight(self) -> int:
        return len(self._flows)

    def exposed_comm_s(self) -> float:
        return self.stats["actual_s"] + self.stats["collective_s"]

    def uncontended_comm_s(self) -> float:
        return (self.stats["uncontended_s"]
                + self.stats["collective_uncontended_s"])


class FabricOps(OperatorModelSet):
    """OperatorModelSet that re-prices inter-node communication over the
    fabric (oversubscribed effective bandwidth, per-hop latency,
    topology-aware ring/tree algorithms) and delegates everything else —
    all compute operators and intra-node collectives — to the wrapped
    model set, so refined/calibrated models compose."""

    def __init__(self, inner: OperatorModelSet, config: FabricConfig,
                 fabric: Optional[Fabric] = None):
        super().__init__(inner.hw)
        self.inner = inner
        self.config = config
        self.fabric = fabric            # stats sink (may be None in tests)

    # effective inter-node bandwidth after oversubscription
    @property
    def _bw(self) -> float:
        return self.hw.inter_node_bw / self.config.oversubscription

    def _account(self, actual: float, uncontended: float) -> float:
        if self.fabric is not None:
            self.fabric.stats["collective_s"] += actual
            self.fabric.stats["collective_uncontended_s"] += uncontended
        return actual

    # ---- compute: pure delegation -----------------------------------------
    def gemm(self, m, n, k, dtype_bytes=2):
        return self.inner.gemm(m, n, k, dtype_bytes)

    def attention_prefill(self, q_lens, kv_lens, n_heads, n_kv_heads,
                          head_dim, causal=True, window=0):
        return self.inner.attention_prefill(q_lens, kv_lens, n_heads,
                                            n_kv_heads, head_dim,
                                            causal=causal, window=window)

    def attention_decode(self, context_lens, n_heads, n_kv_heads, head_dim,
                         window=0):
        return self.inner.attention_decode(context_lens, n_heads,
                                           n_kv_heads, head_dim,
                                           window=window)

    def grouped_gemm(self, tokens_per_group, d_in, d_out, dtype_bytes=2):
        return self.inner.grouped_gemm(tokens_per_group, d_in, d_out,
                                       dtype_bytes)

    def membound(self, nbytes):
        return self.inner.membound(nbytes)

    # ---- collectives: fabric-priced when inter-node -----------------------
    def all_reduce(self, nbytes: float, n: int, *,
                   inter_node: bool = False) -> float:
        if not inter_node or n <= 1:
            return self.inner.all_reduce(nbytes, n, inter_node=inter_node)
        lat = self.config.latency_s
        if self.config.collective == "tree":
            # reduce up + broadcast down a binary tree: ceil(log2 n) levels
            # each way, full payload per level
            hops = 2 * math.ceil(math.log2(n))
            t = hops * (nbytes / self._bw + lat) + self.hw.op_overhead
        else:
            # ring: 2(n-1) steps of nbytes/n each, one hop latency per step
            t = (2.0 * nbytes * (n - 1) / n / self._bw
                 + 2.0 * (n - 1) * lat + self.hw.op_overhead)
        return self._account(t, self.inner.all_reduce(nbytes, n,
                                                      inter_node=True))

    def all_gather(self, nbytes: float, n: int, *,
                   inter_node: bool = False) -> float:
        if not inter_node or n <= 1:
            return self.inner.all_gather(nbytes, n, inter_node=inter_node)
        t = (nbytes * (n - 1) / n / self._bw
             + (n - 1) * self.config.latency_s + self.hw.op_overhead)
        return self._account(t, self.inner.all_gather(nbytes, n,
                                                      inter_node=True))

    def all_to_all(self, nbytes_per_device: float, n: int, *,
                   inter_node: bool = False) -> float:
        if not inter_node or n <= 1:
            return self.inner.all_to_all(nbytes_per_device, n,
                                         inter_node=inter_node)
        t = (nbytes_per_device * (n - 1) / n / self._bw
             + (n - 1) * self.config.latency_s + self.hw.op_overhead)
        return self._account(t, self.inner.all_to_all(nbytes_per_device, n,
                                                      inter_node=True))

    def p2p(self, nbytes: float, *, inter_node: bool = True) -> float:
        if not inter_node:
            return self.inner.p2p(nbytes, inter_node=False)
        t = nbytes / self._bw + self.config.latency_s + self.hw.op_overhead
        return self._account(t, self.inner.p2p(nbytes, inter_node=True))

    def m2n(self, nbytes: float, m: int, n: int, *,
            inter_node: bool = True) -> float:
        """MegaScale-style M2N dispatch/combine: ``m`` senders fan
        ``nbytes`` into ``n`` receivers.  The narrow side's NICs bottleneck
        the aggregate, so the payload crosses min(m, n) parallel uplinks."""
        if not inter_node:
            return self.inner.m2n(nbytes, m, n, inter_node=False)
        lanes = max(min(m, n), 1)
        t = (nbytes / (lanes * self._bw) + self.config.latency_s
             + self.hw.op_overhead)
        return self._account(t, self.inner.m2n(nbytes, m, n,
                                               inter_node=True))
