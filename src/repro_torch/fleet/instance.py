"""One serving instance inside a fleet.

An :class:`Instance` wraps a full single-deployment build (a
``SystemHandle``: GlobalController + clusters + replicas + KV managers)
compiled onto the fleet's SHARED SimEngine, so cross-instance event
ordering stays deterministic.  It adds the control-plane lifecycle the
single-deployment world has no notion of:

- ``starting`` — provisioned, loading weights (modeled cold start); not
  routable yet;
- ``active`` — serving traffic;
- ``draining`` — removed from routing, finishing residents (scale-down);
- ``stopped`` — drained empty; GPUs released.

The instance also integrates provisioned GPU-seconds over its lifetime
(piecewise-constant between state changes), which the FleetReport turns
into the provisioned-but-idle capacity metric.
"""
from __future__ import annotations

from typing import Dict, List, Optional

STARTING = "starting"
ACTIVE = "active"
DRAINING = "draining"
STOPPED = "stopped"


def instance_subspec(spec, group, seed: int):
    """The per-instance SimSpec an InstanceSpec group compiles to: the
    fleet spec's sections with the group's topology/pipeline/memory
    overrides applied and the ``fleet`` section removed (an instance is a
    plain single deployment)."""
    from repro_torch.api.spec import SimSpec
    return SimSpec(
        model=spec.model,
        topology=group.topology if group.topology is not None
        else spec.topology,
        workload=spec.workload,
        policy=spec.policy,
        opmodel=spec.opmodel,
        pipeline=group.pipeline if group.pipeline is not None
        else spec.pipeline,
        memory=group.memory if group.memory is not None else spec.memory,
        slo=spec.slo,
        obs=spec.obs,
        seed=seed,
        name=group.name)


class Instance:
    def __init__(self, name: str, group, handle, *, created_at: float,
                 state: str = ACTIVE):
        self.name = name
        self.group = group              # the InstanceSpec it was built from
        self.handle = handle
        self.state = state
        self.created_at = created_at
        self.active_at: Optional[float] = created_at if state == ACTIVE \
            else None
        self.stopped_at: Optional[float] = None
        self.routed = 0                 # arrivals the global router sent here
        self.has_spares = False         # built with standby P:D replicas
        # GPU-second integrator (piecewise-constant between touches), plus
        # the parallel provisioned-$ integrator (per-cluster $/GPU-hr)
        self._t_last = created_at
        self._dev_last = self.provisioned_devices()
        self._rate_last = self.dollar_rate()
        self.peak_devices = self._dev_last
        self.gpu_seconds = 0.0
        self.provisioned_dollars = 0.0

    # ------------------------------------------------------------- wiring --
    @property
    def controller(self):
        return self.handle.controller

    @property
    def engine(self):
        return self.handle.engine

    @property
    def routable(self) -> bool:
        return self.state == ACTIVE

    # ------------------------------------------------------- load signals --
    def outstanding(self) -> int:
        return self.controller.outstanding()

    def prefix_probe(self, r) -> int:
        return self.controller.prefix_probe(r)

    # ----------------------------------------------------------- arrivals --
    def accept(self, r, now: float) -> None:
        """Hand an arrived request to this instance's controller (the
        fleet already scheduled the arrival event; no re-stamping).

        A rejection (all entry replicas failed) must leave NO trace: a
        half-registered request would pin ``outstanding()`` above zero
        forever — hanging the autoscaler tick loop and drain logic — so
        registration rolls back before the error propagates to the
        fleet's spill path.
        """
        ctrl = self.controller
        r.arrival = now
        prev_start = ctrl.metrics.start
        ctrl.requests[r.rid] = r
        try:
            ctrl._arrive(r)
        except RuntimeError:
            del ctrl.requests[r.rid]
            ctrl.metrics.start = prev_start
            raise
        self.routed += 1

    # ----------------------------------------------------- GPU accounting --
    def provisioned_devices(self) -> int:
        """Devices this instance currently holds: every replica that is
        routable or still finishing work (a drained-empty replica's GPUs
        are released; standby P:D spares consume nothing until enabled)."""
        if self.state == STOPPED:
            return 0
        n = 0
        for cluster in self.handle.clusters.values():
            per = cluster.spec.devices_per_replica() \
                if getattr(cluster, "spec", None) is not None else 1
            for w in cluster.replicas:
                if w.active or w.waiting or w.running or w.swapped \
                        or w._swapping_out or w._swapping_in or w.busy:
                    n += per
        return n

    def dollar_rate(self) -> float:
        """Current provisioned $/hr: held devices weighted by each
        cluster's hardware pricing (mirrors ``provisioned_devices``)."""
        if self.state == STOPPED:
            return 0.0
        rate = 0.0
        for cluster in self.handle.clusters.values():
            per = cluster.spec.devices_per_replica() \
                if getattr(cluster, "spec", None) is not None else 1
            dph = getattr(getattr(cluster, "hw", None),
                          "dollars_per_hour", 0.0)
            for w in cluster.replicas:
                if w.active or w.waiting or w.running or w.swapped \
                        or w._swapping_out or w._swapping_in or w.busy:
                    rate += per * dph
        return rate

    def touch(self, now: float) -> None:
        """Advance the GPU-second and provisioned-$ integrals to ``now``
        and re-sample the (piecewise-constant) provisioned capacity."""
        if now > self._t_last:
            dt = now - self._t_last
            self.gpu_seconds += self._dev_last * dt
            self.provisioned_dollars += self._rate_last * dt / 3600.0
            self._t_last = now
        self._dev_last = self.provisioned_devices()
        self._rate_last = self.dollar_rate()
        if self._dev_last > self.peak_devices:
            self.peak_devices = self._dev_last

    def busy_gpu_seconds(self) -> float:
        total = 0.0
        for cluster in self.handle.clusters.values():
            per = cluster.spec.devices_per_replica() \
                if getattr(cluster, "spec", None) is not None else 1
            total += sum(w.stats["busy_time"] for w in cluster.replicas) * per
        return total

    # ---------------------------------------------------------- lifecycle --
    def activate(self, now: float) -> None:
        assert self.state == STARTING, self.state
        self.state = ACTIVE
        self.active_at = now
        self.touch(now)

    def drain(self, now: float) -> None:
        assert self.state == ACTIVE, self.state
        self.state = DRAINING
        self.touch(now)

    def stop(self, now: float) -> None:
        assert self.outstanding() == 0, (self.name, self.outstanding())
        self.state = STOPPED
        self.stopped_at = now
        self.touch(now)

    # ----------------------------------------------------------- topology --
    @property
    def mode(self) -> str:
        return self.controller.mode

    def pool_replicas(self, role: str, active: bool) -> List:
        """Replicas of ``role`` clusters filtered by routing eligibility
        (the P:D-rebalance working set)."""
        out = []
        for cluster in self.handle.clusters.values():
            if cluster.role != role:
                continue
            for w in cluster.replicas:
                if w.failed:
                    continue
                if w.active == active:
                    out.append(w)
        return out
