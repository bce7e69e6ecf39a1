"""Pluggable global routing policies for multi-instance fleets.

A :class:`FleetRouter` picks which serving *instance* (a full deployment —
its own controller, clusters, KV caches) receives each arriving request.
This is the layer above intra-instance routing: once an instance is
chosen, its GlobalController still load-balances across its own entry
replicas.  Policies are registered in ``FLEET_ROUTERS`` and resolved with
:func:`resolve_fleet_router` (mirroring the MoE-router / batching /
scheduler registries), so specs select them by name::

    fleet:
      router: prefix_affinity            # or {"name": "power_of_two"}

Instances expose two signals routers may read: ``outstanding()`` (requests
submitted and not yet complete) and ``prefix_probe(r)`` (cached-prefix
tokens the instance's entry caches would serve this request).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np


class FleetRouter:
    """Chooses an instance for each arrival; stateful policies allowed
    (state must be driven only by the deterministic event order).

    The FleetController sets ``self.fleet`` after construction; routers
    may read its O(1) aggregate load signals (``outstanding_total``,
    ``all_active()``) instead of summing per-instance state on every
    arrival — bit-identical when every instance is routable.
    """

    name = "base"
    fleet = None                # set by FleetController.__init__

    def select(self, r, instances: Sequence, now: float,
               rng: np.random.Generator):
        """Return one of ``instances`` (never empty, all routable)."""
        raise NotImplementedError


class RoundRobinRouter(FleetRouter):
    """Cycle through routable instances in stable (creation) order."""

    name = "round_robin"

    def __init__(self):
        self._i = 0

    def select(self, r, instances, now, rng):
        inst = instances[self._i % len(instances)]
        self._i += 1
        return inst


class LeastOutstandingRouter(FleetRouter):
    """Global least-loaded: fewest submitted-but-incomplete requests."""

    name = "least_outstanding"

    def select(self, r, instances, now, rng):
        return min(instances, key=lambda i: (i.outstanding(), i.name))


class PowerOfTwoRouter(FleetRouter):
    """Power-of-two-choices: sample two instances, keep the less loaded —
    near-optimal balance at O(1) state (Mitzenmacher), and the standard
    production compromise when polling every instance is too chatty."""

    name = "power_of_two"

    def select(self, r, instances, now, rng):
        if len(instances) < 2:
            return instances[0]
        a, b = rng.choice(len(instances), size=2, replace=False)
        return min((instances[int(a)], instances[int(b)]),
                   key=lambda i: (i.outstanding(), i.name))


class PrefixAffinityRouter(FleetRouter):
    """Cache-aware routing: requests of a shared-prefix group stick to the
    instance whose prefix cache holds (or will hold) their prefix.

    The first request of a group is placed least-loaded and recorded as the
    group's home; later members follow it — unless the home is gone
    (drained/stopped) or overloaded past ``overload_factor`` times the
    fleet mean, in which case they divert least-loaded *without* moving the
    home (a temporary spill, not a cache migration).  When no home is
    recorded the router probes actual caches (``prefix_probe``) so it
    re-discovers prefixes that outlive their routing state.
    """

    name = "prefix_affinity"

    def __init__(self, overload_factor: float = 2.0):
        if overload_factor <= 1.0:
            raise ValueError(f"overload_factor must be > 1, "
                             f"got {overload_factor}")
        self.overload_factor = overload_factor
        self._home: Dict[int, str] = {}      # prefix_id -> instance name

    def _least(self, instances):
        return min(instances, key=lambda i: (i.outstanding(), i.name))

    def select(self, r, instances, now, rng):
        pid = getattr(r, "prefix_id", None)
        if pid is None:
            return self._least(instances)
        by_name = {i.name: i for i in instances}
        home = by_name.get(self._home.get(pid))
        if home is None:
            hits = [(i.prefix_probe(r), i.name, i) for i in instances]
            best = max(hits, key=lambda h: (h[0], h[1]))
            home = best[2] if best[0] > 0 else self._least(instances)
            self._home[pid] = home.name
            return home
        fleet = self.fleet
        if fleet is not None and fleet.all_active():
            # candidates == all instances: the maintained total replaces
            # the O(n_instances) sum (exact, not approximate)
            mean = fleet.outstanding_total / len(instances)
        else:
            mean = sum(i.outstanding() for i in instances) / len(instances)
        if home.outstanding() > self.overload_factor * (mean + 1.0):
            return self._least(instances)
        return home


FLEET_ROUTERS = {
    "round_robin": RoundRobinRouter,
    "least_outstanding": LeastOutstandingRouter,
    "power_of_two": PowerOfTwoRouter,
    "prefix_affinity": PrefixAffinityRouter,
}


def resolve_fleet_router(spec: Union[None, str, dict, FleetRouter],
                         ) -> FleetRouter:
    """Uniform fleet-router argument handling (mirrors resolve_router).

    Accepts an instance (returned as-is), a registered name, a mapping
    ``{"name": ..., **kwargs}`` whose kwargs go to the constructor (e.g.
    ``{"name": "prefix_affinity", "overload_factor": 3.0}``), or None
    (the least_outstanding default).
    """
    if spec is None:
        return LeastOutstandingRouter()
    if isinstance(spec, FleetRouter):
        return spec
    if isinstance(spec, str):
        spec = {"name": spec}
    if isinstance(spec, dict):
        kw = dict(spec)
        name = kw.pop("name", None)
        try:
            cls = FLEET_ROUTERS[name]
        except KeyError:
            raise KeyError(f"unknown fleet router {name!r}; registered: "
                           f"{sorted(FLEET_ROUTERS)}")
        try:
            return cls(**kw)
        except (TypeError, ValueError) as e:
            raise TypeError(f"fleet router {name!r} could not be "
                            f"constructed from {kw!r} ({e})") from e
    raise TypeError(f"fleet router must be None, a name, a mapping, or a "
                    f"FleetRouter; got {type(spec).__name__}")
