"""FleetController: the control plane over N serving instances.

Owns the shared SimEngine's fleet-level events: request arrivals (tenant
assignment + global routing), instance lifecycle (cold-started scale-up,
drain-then-release scale-down, P:D pool rebalancing), and the autoscaler
tick loop.  Every instance is a full single-deployment build
(:mod:`repro_torch.fleet.instance`); the controller only ever talks to the
instance surface (``outstanding`` / ``prefix_probe`` / ``accept``), never
to replicas directly — intra-instance scheduling stays the
GlobalController's job.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.engine import SimEngine
from repro_torch.core.events import EV
from repro_torch.fleet.instance import (
    ACTIVE, DRAINING, STARTING, Instance, instance_subspec,
)
from repro_torch.fleet.router import resolve_fleet_router


class FleetController:
    def __init__(self, spec, engine: SimEngine, *,
                 hardware=None, ops=None, engine_overhead=None,
                 telemetry=None, device="cuda"):
        from repro_torch.fleet.autoscaler import Autoscaler
        self.spec = spec
        self.fleet = spec.fleet
        self.engine = engine
        self._hardware = hardware
        self._ops = ops
        self._engine_overhead = engine_overhead
        self._device = device             # handed to every instance's build
        # set before the initial instance builds below so every instance
        # (initial and scaled-up alike) is wired through _build_instance
        self.telemetry = telemetry
        self.rng = np.random.default_rng([spec.seed, 0xF1EE7])
        # windowed mode: every instance runs on its OWN sub-engine and the
        # fleet engine only carries control-plane events (arrivals, ticks,
        # lifecycle); repro_torch.fleet.windowed advances them in conservative
        # time windows.  Serial mode shares ONE engine across everything.
        self.windowed = getattr(self.fleet, "engine", "serial") == "windowed"
        self.router = resolve_fleet_router(self.fleet.router)
        self.router.fleet = self     # O(1) aggregate load signals
        self.instances: Dict[str, Instance] = {}
        self._built = 0                   # lifetime instance counter (seeds)
        self.scale_events: List[dict] = []
        self.recent_completed: List = []  # completions since last tick
        self.peak_devices = 0
        self.total_requests = 0
        self.last_arrival = 0.0
        self._moves_in_flight = 0         # pending P:D reconfigurations
        # O(1) load signals for routers: exact mirrors of
        # sum(i.outstanding()) and of the any-non-ACTIVE-instance test,
        # maintained at accept/complete and on lifecycle transitions
        self.outstanding_total = 0
        self._non_active = 0
        # tenant classes: weighted assignment, priorities via timestamps
        self.tenants = list(self.fleet.tenants)
        w = np.array([t.weight for t in self.tenants], float)
        self._tenant_p = w / w.sum() if len(w) else None
        self.autoscaler = (Autoscaler(self.fleet.autoscaler, self)
                           if self.fleet.autoscaler is not None else None)
        for group in self.fleet.instances:
            for _ in range(group.count):
                self._build_instance(group, state=ACTIVE)
        self._track_peak()
        self._apply_faults()

    # ------------------------------------------------------------ building --
    def _build_instance(self, group, state: str) -> Instance:
        from repro_torch.api.run import build
        self._built += 1
        name = f"{group.name}-{self._built - 1}"
        sub = instance_subspec(self.spec, group,
                               seed=self.spec.seed + 7919 * self._built)
        a = self.fleet.autoscaler
        has_spares = (a is not None and a.pd_rebalance and a.pd_spares > 0
                      and sub.topology.preset == "pd")
        if has_spares:
            # standby capacity for P:D rebalancing: build each pool with
            # pd_spares extra replicas; provision_spares parks the extras
            # inactive (they hold no GPUs until a pool move enables them).
            # Only the pd preset's pool knobs support this — inline PD
            # graphs keep their declared replica counts untouched.
            from dataclasses import replace
            sub.topology = replace(sub.topology,
                                   n_prefill=sub.topology.n_prefill
                                   + a.pd_spares,
                                   n_decode=sub.topology.n_decode
                                   + a.pd_spares)
        inst_engine = SimEngine() if self.windowed else self.engine
        handle = build(sub, hardware=self._hardware, ops=self._ops,
                       engine=inst_engine, device=self._device)
        if self.windowed:
            # a scale-up mid-run starts the sub-engine at the fleet clock
            inst_engine.advance_to(self.engine.now)
        if self._engine_overhead is not None:
            for cluster in handle.clusters.values():
                for w in cluster.replicas:
                    w.predictor.engine_overhead = self._engine_overhead
        if has_spares:
            # park the extras BEFORE the Instance samples its device
            # count, so standbys never enter peak/GPU-second accounting
            for cluster in handle.clusters.values():
                pool = cluster.active_replicas()
                for w in pool[len(pool) - a.pd_spares:]:
                    w.active = False
        if self.telemetry is not None:
            from repro_torch.obs import attach_telemetry
            attach_telemetry(handle, self.telemetry, instance=name)
        inst = Instance(name, group, handle,
                        created_at=self.engine.now, state=state)
        if state != ACTIVE:
            self._non_active += 1
        inst.has_spares = has_spares
        handle.controller.observer = \
            lambda r, w, inst=inst: self._on_complete(inst, r)
        self.instances[name] = inst
        inst.touch(self.engine.now)
        self._tel_burn(self.engine.now)
        return inst

    def _apply_faults(self) -> None:
        """Faults land on the FIRST instance of the named group (or of the
        first group when ``instance`` is unset)."""
        from repro_torch.api.spec import SpecError
        for i, f in enumerate(self.spec.faults):
            group = self.fleet.instance_by_name(f.instance)
            inst = next(x for x in self.instances.values()
                        if x.group is group)
            cluster = inst.handle.clusters.get(f.cluster)
            if cluster is None:
                raise SpecError(
                    f"faults[{i}].cluster: instance group "
                    f"{group.name!r} has no cluster {f.cluster!r} "
                    f"(clusters: {sorted(inst.handle.clusters)})")
            if f.replica >= len(cluster.replicas):
                raise SpecError(
                    f"faults[{i}].replica: index {f.replica} out of range "
                    f"— cluster {f.cluster!r} of {inst.name!r} has "
                    f"{len(cluster.replicas)} replicas")
            if f.kind == "failure":
                inst.controller.inject_failure(f.cluster, f.replica,
                                               at=f.at, downtime=f.downtime)
            else:
                cluster.replicas[f.replica].slowdown = f.slowdown

    def _track_peak(self) -> None:
        now = sum(i.provisioned_devices() for i in self.instances.values())
        if now > self.peak_devices:
            self.peak_devices = now

    # ------------------------------------------------------------ arrivals --
    def submit_all(self, requests: List) -> None:
        """Stamp tenants (rid order, so assignment is independent of event
        interleaving) and schedule one fleet-level arrival per request."""
        self.total_requests = len(requests)
        self.last_arrival = max((r.arrival for r in requests), default=0.0)
        if self.tenants:
            draws = self.rng.choice(len(self.tenants), size=len(requests),
                                    p=self._tenant_p)
            for r, d in zip(requests, draws):
                t = self.tenants[int(d)]
                r.tenant = t.name
                r.timestamps["priority"] = float(t.priority)
        arr = [r.arrival for r in requests]
        if any(a > b for a, b in zip(arr, arr[1:])):
            for r in requests:
                self.engine.at(r.arrival, EV.REQUEST_ARRIVAL,
                               lambda ev, r=r: self._arrive(r), rid=r.rid,
                               fleet=True)
        else:
            # sorted arrivals ride the engine's bulk timeline (no heap
            # traffic; seqs assigned in request order => identical ties)
            self.engine.schedule_timeline(
                (r.arrival, EV.REQUEST_ARRIVAL, self._arrive_ev, r)
                for r in requests)
        if self.autoscaler is not None:
            self.autoscaler.start()

    def _arrive_ev(self, ev) -> None:
        self._arrive(ev.data)

    def routable_instances(self) -> List[Instance]:
        return [i for i in self.instances.values() if i.routable]

    def _arrive(self, r) -> None:
        now = self.engine.now
        candidates = self.routable_instances()
        if not candidates:
            raise RuntimeError("fleet: no active instances to route to")
        chosen = self.router.select(r, candidates, now, self.rng)
        # an instance whose entry replicas are all down (fault injection)
        # rejects; spill to the remaining instances before giving up
        if self._accept(chosen, r, now):
            self._tel_route(r, chosen, now)
            return
        for inst in candidates:
            if inst is not chosen and self._accept(inst, r, now):
                self._tel_route(r, inst, now, spilled=True)
                return
        raise RuntimeError("fleet: no instance has healthy entry replicas")

    def _tel_route(self, r, inst: Instance, now: float,
                   spilled: bool = False) -> None:
        tel = self.telemetry
        if tel is None:
            return
        meta = {"instance": inst.name}
        if getattr(r, "tenant", None) is not None:
            meta["tenant"] = r.tenant
        if spilled:
            meta["spilled"] = True
        tel.span("fleet_route", r.rid, now, now, **meta)
        tel.counter("outstanding", now, inst.outstanding(),
                    instance=inst.name)
        tel.counter("fleet_outstanding", now, self.outstanding_total)

    def _accept(self, inst: Instance, r, now: float) -> bool:
        if self.windowed and inst.engine is not self.engine \
                and inst.engine.now < now:
            # conservative windows: the instance's clock is still behind
            # this arrival, so the hand-off fires on ITS engine at the
            # true arrival time.  Registration is eager — the router's
            # load signals must see this request immediately, exactly as
            # in serial mode — only the scheduling side is deferred.
            ctrl = inst.controller
            r.arrival = now
            ctrl.requests[r.rid] = r
            inst.routed += 1
            self.outstanding_total += 1
            inst.engine.at(now, EV.REQUEST_ARRIVAL,
                           lambda ev, inst=inst, r=r:
                           self._deferred_arrive(inst, r),
                           rid=r.rid, fleet=True)
            return True
        try:
            inst.accept(r, now)
        except RuntimeError:
            return False
        self.outstanding_total += 1
        return True

    def _deferred_arrive(self, inst: Instance, r) -> None:
        """Fire an eagerly-registered arrival on the instance engine; a
        rejection (entry replicas all failed) rolls the registration back
        and spills to the surviving instances."""
        ctrl = inst.controller
        prev_start = ctrl.metrics.start
        try:
            ctrl._arrive(r)
        except RuntimeError:
            del ctrl.requests[r.rid]
            ctrl.metrics.start = prev_start
            inst.routed -= 1
            self.outstanding_total -= 1
            for other in self.routable_instances():
                if other is not inst and self._accept(other, r, r.arrival):
                    return
            raise RuntimeError(
                "fleet: no instance has healthy entry replicas")

    # --------------------------------------------------------- completions --
    def _on_complete(self, inst: Instance, r) -> None:
        if self.autoscaler is not None:     # its attainment window is the
            self.recent_completed.append(r)  # only consumer of this list
        # the instance's own clock: identical to self.engine.now in serial
        # mode (one shared engine), and the *correct* completion time in
        # windowed mode, where the fleet engine waits at a barrier
        now = inst.engine.now
        self.outstanding_total -= 1
        tel = self.telemetry
        if tel is not None:
            tel.counter("outstanding", now, inst.outstanding(),
                        instance=inst.name)
            tel.counter("fleet_outstanding", now, self.outstanding_total)
        inst.touch(now)
        if inst.state == DRAINING and inst.outstanding() == 0:
            inst.stop(now)
            self._record_at("drained", inst, now)

    def outstanding(self) -> int:
        return sum(i.outstanding() for i in self.instances.values())

    def all_active(self) -> bool:
        """True iff every built instance is routable — the condition under
        which ``outstanding_total`` equals the sum of ``outstanding()``
        over exactly the router's candidate set."""
        return self._non_active == 0

    # ------------------------------------------------------- scale actions --
    def _record(self, kind: str, inst: Instance, **extra) -> None:
        self._record_at(kind, inst, self.engine.now, **extra)

    def _record_at(self, kind: str, inst: Instance, t: float,
                   **extra) -> None:
        self.scale_events.append(dict(
            t=t, kind=kind, instance=inst.name, **extra))
        if self.telemetry is not None:
            self._tel_burn(t)
            self.telemetry.span(kind, -1, t, t, instance=inst.name)

    def _tel_burn(self, t: float) -> None:
        """Sample the fleet $/hr staircase — the rate steps exactly at
        instance builds and lifecycle transitions, so sampling there
        captures it completely."""
        tel = self.telemetry
        if tel is not None:
            rate = sum(i.dollar_rate() for i in self.instances.values()
                       if i.stopped_at is None)
            tel.counter("fleet_dollars_per_hour", t, rate)

    def _replica_rate(self, inst: Instance, w) -> float:
        """Provisioned $/hr one replica represents (its cluster's per-
        replica device count times that cluster's hardware price)."""
        for cluster in inst.handle.clusters.values():
            if w in cluster.replicas:
                per = cluster.spec.devices_per_replica() \
                    if getattr(cluster, "spec", None) is not None else 1
                return per * getattr(getattr(cluster, "hw", None),
                                     "dollars_per_hour", 0.0)
        return 0.0

    def scale_up(self, group) -> Instance:
        """Provision one more instance of ``group`` with a modeled cold
        start: per-device weight bytes over the provision bandwidth plus
        the runtime bring-up floor.  Routable once INSTANCE_READY fires."""
        a = self.fleet.autoscaler
        inst = self._build_instance(group, state=STARTING)
        first = next(iter(inst.handle.clusters.values())).replicas[0]
        cold = (first.predictor.weight_bytes_per_device() / a.provision_bw
                + a.startup_base_s)
        self.engine.after(cold, EV.INSTANCE_READY,
                          lambda ev, inst=inst: self._instance_ready(inst),
                          instance=inst.name)
        self._record("scale_up", inst, cold_start_s=cold,
                     dollars_per_hour_delta=inst.dollar_rate())
        self._track_peak()
        return inst

    def _instance_ready(self, inst: Instance) -> None:
        inst.activate(self.engine.now)
        self._non_active -= 1
        self._record("ready", inst)
        self._track_peak()

    def scale_down(self, inst: Instance) -> None:
        """Drain: stop routing to ``inst``; it finishes residents and then
        releases its GPUs (``_on_complete`` notices the drain emptying)."""
        # price the decision when it is made: the drained capacity keeps
        # burning $ until residents finish, but this is the rate the
        # autoscaler chose to give up
        rate = inst.dollar_rate()
        inst.drain(self.engine.now)
        self._non_active += 1
        self._record("scale_down", inst, dollars_per_hour_delta=-rate)
        if inst.outstanding() == 0:
            inst.stop(self.engine.now)
            self._record("drained", inst)

    def rebalance_pd(self, inst: Instance, donor_role: str,
                     needy_role: str) -> bool:
        """Move one replica of capacity between an instance's P and D
        pools: drain one ``donor_role`` replica now, enable a standby
        ``needy_role`` replica after the modeled weight reload."""
        spares = inst.pool_replicas(needy_role, active=False)
        spare = next((w for w in spares
                      if not (w.waiting or w.running or w.busy)), None)
        donors = inst.pool_replicas(donor_role, active=True)
        if spare is None or len(donors) <= 1:
            return False
        donor = max(donors, key=lambda w: (w.load(), w.name))
        donor.active = False
        self._moves_in_flight += 1

        def enable(ev, w=spare, inst=inst):
            self._moves_in_flight -= 1
            w.active = True
            w.kick()
            inst.touch(self.engine.now)
            self._track_peak()

        self.engine.after(self.fleet.autoscaler.reconfigure_s,
                          EV.POOL_RECONFIGURED, enable,
                          instance=inst.name, role=needy_role)
        self._record("rebalance", inst, moved=f"{donor_role}->{needy_role}",
                     donor=donor.name, spare=spare.name,
                     dollars_per_hour_delta=(
                         self._replica_rate(inst, spare)
                         - self._replica_rate(inst, donor)))
        inst.touch(self.engine.now)
        return True

    # ----------------------------------------------------------- finishing --
    def finalize(self) -> None:
        """Close the GPU-second integrals at the END OF THE WORKLOAD (the
        last completion/token), not at engine.now — trailing autoscaler
        ticks drain the event heap up to interval_s past the last
        completion, and charging that tail as idle capacity would make
        autoscaler-on runs look wasteful even when it never acted."""
        end = max((i.controller.metrics.end
                   for i in self.instances.values()), default=0.0)
        if end <= 0.0:          # horizon cut before any token: use now
            end = self.engine.now
        for inst in self.instances.values():
            inst.touch(end)
        self._track_peak()

    def conservation_check(self) -> Dict[str, int]:
        states: Dict[str, int] = {}
        for inst in self.instances.values():
            for k, v in inst.controller.conservation_check().items():
                states[k] = states.get(k, 0) + v
        return states
