"""SLO-driven fleet autoscaling.

The autoscaler wakes on a fixed tick, reads two signals — mean outstanding
requests per active instance (queue depth) and, when the spec carries an
SLO, the TTFT-SLO attainment of completions since the previous tick — and
takes at most one action per tick, rate-limited by a cooldown:

- **up**: queue depth above ``up_queue_depth`` OR recent attainment below
  ``slo_attainment_floor`` → provision a clone of the template group with
  a modeled cold start (weights over ``provision_bw``);
- **down**: queue depth below ``down_queue_depth`` for two consecutive
  ticks (hysteresis) and more than ``min_instances`` active → drain the
  least-loaded instance (stop routing, finish residents, release GPUs);
- **rebalance** (``pd_rebalance``): inside disaggregated instances, when
  one pool's per-replica queue pressure exceeds ``rebalance_ratio`` times
  the other's, shift one replica of capacity between the prefill and
  decode pools via pre-provisioned standby replicas.

Ticks stop rescheduling once every arrival has fired and the fleet is
empty, so the event heap always drains and runs terminate.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.events import EV
from repro_torch.core.metrics import slo_attainment
from repro_torch.fleet.instance import ACTIVE, STARTING


class Autoscaler:
    def __init__(self, spec, fleet):
        self.spec = spec          # AutoscalerSpec
        self.fleet = fleet        # FleetController
        self._last_action = -float("inf")
        self._down_streak = 0

    # --------------------------------------------------------------- tick --
    def start(self) -> None:
        self._schedule()

    def _schedule(self) -> None:
        self.fleet.engine.after(self.spec.interval_s, EV.AUTOSCALE_TICK,
                                lambda ev: self._tick())

    def _tick(self) -> None:
        fleet, now = self.fleet, self.fleet.engine.now
        self.act(now)
        # deliberately no inst.touch() here: GPU-second integration only
        # advances on provisioning changes and completions, so an idle
        # tick after the last completion never charges phantom idle time
        fleet._track_peak()
        # keep ticking while arrivals are still due or work is in flight
        # (or a pool move / cold start is pending — its event finishes the
        # heap either way, but the tick loop must not outlive the run)
        if now < fleet.last_arrival or fleet.outstanding() > 0:
            self._schedule()

    # ------------------------------------------------------------- policy --
    def act(self, now: float) -> None:
        fleet, spec = self.fleet, self.spec
        actives = [i for i in fleet.instances.values() if i.state == ACTIVE]
        starting = [i for i in fleet.instances.values()
                    if i.state == STARTING]
        recent = fleet.recent_completed
        fleet.recent_completed = []
        if not actives:
            return
        if spec.pd_rebalance:
            self._rebalance(actives)
        depth = sum(i.outstanding() for i in actives) / len(actives)
        slo = fleet.spec.slo
        attain: Optional[float] = None
        if slo is not None and spec.slo_attainment_floor is not None:
            attain = slo_attainment(recent, ttft_s=slo.ttft_s)
        if now - self._last_action < spec.cooldown_s:
            return
        n = len(actives) + len(starting)
        want_up = (depth > spec.up_queue_depth
                   or (attain is not None
                       and attain < spec.slo_attainment_floor))
        if want_up and n < spec.max_instances:
            group = fleet.fleet.instance_by_name(spec.template)
            fleet.scale_up(group)
            self._last_action = now
            self._down_streak = 0
            return
        if depth < spec.down_queue_depth and n > spec.min_instances \
                and not starting:
            self._down_streak += 1
            if self._down_streak >= 2:      # hysteresis: two calm ticks
                victim = min(actives,
                             key=lambda i: (i.outstanding(), i.name))
                fleet.scale_down(victim)
                self._last_action = now
                self._down_streak = 0
        else:
            self._down_streak = 0

    def _rebalance(self, actives) -> None:
        spec, fleet = self.spec, self.fleet
        if fleet._moves_in_flight:
            return                      # one pool move in flight at a time
        for inst in actives:
            if not inst.has_spares:
                continue
            depths = inst.controller.pool_depths()
            n_p = max(len(inst.pool_replicas("prefill", active=True)), 1)
            n_d = max(len(inst.pool_replicas("decode", active=True)), 1)
            p = depths.get("prefill", 0) / n_p
            d = depths.get("decode", 0) / n_d
            if p > spec.rebalance_ratio * (d + 1.0):
                if fleet.rebalance_pd(inst, "decode", "prefill"):
                    return
            elif d > spec.rebalance_ratio * (p + 1.0):
                if fleet.rebalance_pd(inst, "prefill", "decode"):
                    return
