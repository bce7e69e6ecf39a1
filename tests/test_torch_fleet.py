"""The reference's fleet control-plane cases (``tests/test_fleet.py``)
through the port, on the CPU: spec plumbing, routing policies, autoscaling
lifecycle, P:D rebalancing, fleet-wide conservation (hypothesis), and
byte-identical determinism of FleetReport; then the same fleet specs
through both packages, whose reports must be equal."""
import json

import pytest

import repro.api as R
from repro.fleet import FleetReport as RFleetReport
from repro_torch.api import SimSpec, SpecError
from repro_torch.api import build as _build, run as _run
from repro_torch.api.run import Report
from repro_torch.fleet import FLEET_ROUTERS, FleetReport, resolve_fleet_router
from repro_torch.fleet.router import PrefixAffinityRouter


def run(spec, **kwargs):
    """The port's ``run`` on the CPU, as every case here calls it."""
    return _run(spec, device="cpu", **kwargs)


try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # property test skips; the rest still runs
    HAVE_HYPOTHESIS = False

SMOKE = {"name": "qwen2-7b", "smoke": True}


def _fleet_spec(n_requests=60, router="least_outstanding", instances=None,
                autoscaler=None, tenants=None, faults=None, **workload):
    wl = {"n_requests": n_requests, "rate": 40.0, "prompt_mean": 128,
          "output_mean": 16, "seed": 9}
    wl.update(workload)
    d = {
        "name": "fleet-test",
        "model": SMOKE,
        "topology": {"preset": "colocated"},
        "workload": wl,
        "fleet": {
            "instances": instances or [{"name": "colo", "count": 2}],
            "router": router,
        },
        "seed": 9,
    }
    if autoscaler is not None:
        d["fleet"]["autoscaler"] = autoscaler
    if tenants is not None:
        d["fleet"]["tenants"] = tenants
    if faults is not None:
        d["faults"] = faults
    return SimSpec.from_dict(d)


# ------------------------------------------------------------------ spec --
def test_fleet_spec_round_trip():
    spec = _fleet_spec(
        instances=[{"name": "a", "count": 2},
                   {"name": "b", "count": 1,
                    "topology": {"preset": "pd", "n_decode": 2},
                    "memory": {"manager": "prefix"}}],
        autoscaler={"max_instances": 4, "template": "a"},
        tenants=[{"name": "paid", "weight": 1.0, "ttft_s": 0.5}])
    assert SimSpec.from_yaml(spec.to_yaml()) == spec
    assert SimSpec.from_dict(spec.to_dict()) == spec
    assert SimSpec.from_yaml(spec.to_yaml()).spec_hash() == spec.spec_hash()


def test_fleet_spec_validation_errors():
    with pytest.raises(SpecError, match="fleet.instances"):
        SimSpec.from_dict({"model": SMOKE,
                           "fleet": {"instances": []}}).validate()
    with pytest.raises(KeyError, match="unknown fleet router"):
        resolve_fleet_router("nope")
    with pytest.raises(SpecError, match="fleet.router"):
        _fleet_spec(router="nope").validate()
    with pytest.raises(SpecError, match="duplicate group"):
        _fleet_spec(instances=[{"name": "a"}, {"name": "a"}]).validate()
    with pytest.raises(SpecError, match="closed-loop"):
        _fleet_spec(arrival="closed", concurrency=4).validate()
    with pytest.raises(SpecError, match="min_instances"):
        _fleet_spec(autoscaler={"min_instances": 3,
                                "max_instances": 1}).validate()
    with pytest.raises(SpecError, match="unknown instance group"):
        _fleet_spec(autoscaler={"template": "nope"}).validate()
    with pytest.raises(SpecError, match="weight"):
        _fleet_spec(tenants=[{"name": "t", "weight": 0}]).validate()
    with pytest.raises(SpecError, match="named instances"):
        spec = SimSpec.from_dict({
            "model": SMOKE,
            "faults": [{"kind": "failure", "cluster": "colocated",
                        "instance": "colo"}]})
        spec.validate()


def test_registry_has_all_four_policies():
    assert set(FLEET_ROUTERS) == {"round_robin", "least_outstanding",
                                  "power_of_two", "prefix_affinity"}
    r = resolve_fleet_router({"name": "prefix_affinity",
                              "overload_factor": 3.0})
    assert isinstance(r, PrefixAffinityRouter)
    assert r.overload_factor == 3.0


def test_single_instance_specs_unchanged():
    """No fleet section -> the legacy Report path, bit-for-bit."""
    d = {"model": SMOKE,
         "workload": {"n_requests": 20, "rate": 20.0, "seed": 1},
         "seed": 1}
    rep = run(SimSpec.from_dict(d))
    assert isinstance(rep, Report) and not isinstance(rep, FleetReport)
    assert rep.all_complete


# --------------------------------------------------------------- routing --
def test_every_router_conserves_and_completes():
    for router in sorted(FLEET_ROUTERS):
        rep = run(_fleet_spec(router=router))
        assert isinstance(rep, FleetReport)
        assert rep.all_complete, (router, rep.conservation)
        assert sum(i["routed"] for i in rep.instances.values()) == 60


def test_round_robin_is_even():
    rep = run(_fleet_spec(router="round_robin", n_requests=64))
    counts = [i["routed"] for i in rep.instances.values()]
    assert counts == [32, 32]
    assert rep.summary["routing_imbalance"] == 0.0


def test_prefix_affinity_beats_round_robin_on_hit_rate():
    """Acceptance: cache-aware routing exploits the PR-4 prefix cache —
    one cold miss per group instead of one per (group, instance)."""
    base = {
        "model": SMOKE,
        "topology": {"preset": "colocated"},
        "workload": {"n_requests": 200, "rate": 40.0, "prompt_mean": 128,
                     "output_mean": 16, "prefix_groups": 8,
                     "prefix_len": 512, "seed": 5},
        "memory": {"manager": "prefix"},
        "fleet": {"instances": [{"name": "colo", "count": 4}]},
        "seed": 5,
    }
    hits = {}
    for router in ("round_robin", "prefix_affinity"):
        d = json.loads(json.dumps(base))
        d["fleet"]["router"] = router
        rep = run(SimSpec.from_dict(d))
        assert rep.all_complete
        hits[router] = rep.summary["prefix_hit_token_frac"]
    assert hits["prefix_affinity"] > hits["round_robin"]


# ----------------------------------------------------------- autoscaling --
def test_scale_up_has_cold_start_and_scale_down_drains():
    rep = run(_fleet_spec(
        n_requests=800, rate=120.0, prompt_mean=512, output_mean=64,
        instances=[{"name": "colo", "count": 1}],
        autoscaler={"min_instances": 1, "max_instances": 4,
                    "interval_s": 1.0, "cooldown_s": 2.0,
                    "up_queue_depth": 6.0, "down_queue_depth": 1.0,
                    "provision_bw": 64e9, "startup_base_s": 0.5}))
    assert rep.all_complete
    assert rep.summary["scale_up_events"] >= 1
    ups = {e["instance"]: e for e in rep.scale_events
           if e["kind"] == "scale_up"}
    readies = {e["instance"]: e for e in rep.scale_events
               if e["kind"] == "ready"}
    for name, up in ups.items():
        assert up["cold_start_s"] > 0.5          # weight load is modeled
        assert readies[name]["t"] == pytest.approx(
            up["t"] + up["cold_start_s"])
    # a drained instance released its GPUs and kept its completed work
    for e in rep.scale_events:
        if e["kind"] == "drained":
            blk = rep.instances[e["instance"]]
            assert blk["state"] == "stopped"
            assert blk["outstanding"] == 0
    assert rep.summary["provisioned_gpu_seconds"] > 0
    assert rep.summary["idle_gpu_seconds"] >= 0


def test_pd_rebalance_moves_capacity():
    rep = run(_fleet_spec(
        n_requests=300, arrival="burst", burst_size=100, burst_period=2.0,
        prompt="fixed", prompt_mean=2048, output="fixed", output_mean=8,
        instances=[{"name": "pd", "count": 1,
                    "topology": {"preset": "pd", "n_prefill": 1,
                                 "n_decode": 2}}],
        autoscaler={"min_instances": 1, "max_instances": 1,
                    "interval_s": 0.25, "cooldown_s": 0.5,
                    "up_queue_depth": 1e9,
                    "pd_rebalance": True, "pd_spares": 1,
                    "rebalance_ratio": 2.0, "reconfigure_s": 0.2}))
    assert rep.all_complete
    assert rep.summary["rebalance_events"] >= 1
    moves = [e for e in rep.scale_events if e["kind"] == "rebalance"]
    assert all(e["moved"] in ("decode->prefill", "prefill->decode")
               for e in moves)


def test_build_rejects_fleet_specs():
    """build() compiles one deployment; silently dropping the fleet
    section would yield plausible-but-wrong single-instance results."""
    with pytest.raises(SpecError, match="fleet"):
        _build(_fleet_spec(), device="cpu")


def test_cluster_keyed_batching_must_exist_in_every_group():
    """The policy section is shared by every instance: a batching key
    naming one group's inline cluster fails at validate(), not mid-build
    of another group."""
    spec = _fleet_spec(
        instances=[{"name": "inline", "count": 1,
                    "topology": {"preset": None, "clusters": [
                        {"name": "pre", "role": "prefill"},
                        {"name": "dec", "role": "decode"}]}},
                   {"name": "colo", "count": 1}])
    spec.policy.batching = {"pre": {"name": "continuous"}}
    with pytest.raises(SpecError, match="policy.batching"):
        spec.validate()


def test_spares_excluded_from_device_accounting():
    """Parked P:D standbys hold no GPUs: the instance's device count and
    GPU-second integral cover only the serving replicas."""
    rep = run(_fleet_spec(
        n_requests=40,
        instances=[{"name": "pd", "count": 1,
                    "topology": {"preset": "pd", "n_prefill": 1,
                                 "n_decode": 1}}],
        autoscaler={"min_instances": 1, "max_instances": 1,
                    "interval_s": 0.5, "up_queue_depth": 1e9,
                    "pd_rebalance": True, "pd_spares": 1}))
    assert rep.all_complete
    blk = next(iter(rep.instances.values()))
    if not rep.summary["rebalance_events"]:
        assert blk["devices"] == 2       # 1 prefill + 1 decode, no spares
        assert blk["gpu_seconds"] <= 2 * rep.summary["duration_s"] * 1.5


def test_idle_autoscaler_does_not_inflate_gpu_seconds():
    """Regression: trailing AUTOSCALE_TICK events past the last completion
    must not be charged as provisioned/idle capacity — an autoscaler that
    never acts reports the same GPU-seconds as no autoscaler at all."""
    plain = run(_fleet_spec(n_requests=60))
    lazy = run(_fleet_spec(
        n_requests=60,
        autoscaler={"min_instances": 2, "max_instances": 2,
                    "interval_s": 0.5, "up_queue_depth": 1e9,
                    "down_queue_depth": -1.0}))
    assert lazy.summary["scale_up_events"] == 0
    assert lazy.summary["scale_down_events"] == 0
    assert lazy.summary["provisioned_gpu_seconds"] == pytest.approx(
        plain.summary["provisioned_gpu_seconds"])
    assert lazy.summary["idle_gpu_seconds"] == pytest.approx(
        plain.summary["idle_gpu_seconds"])


def test_fault_cluster_checked_against_target_group_at_validate():
    """Regression: a fault naming a cluster from a DIFFERENT group than
    its instance target must fail at validate(), not mid-build."""
    spec = _fleet_spec(
        instances=[{"name": "colo", "count": 1},
                   {"name": "pd", "count": 1,
                    "topology": {"preset": "pd"}}],
        faults=[{"kind": "failure", "cluster": "prefill", "replica": 0,
                 "instance": "colo"}])
    with pytest.raises(SpecError, match="faults\\[0\\].cluster"):
        spec.validate()


def test_spill_during_total_instance_outage_conserves():
    """Regression: an instance whose ONLY replica is down must reject
    arrivals without registering them — a phantom entry would pin its
    outstanding() above zero forever (hanging autoscaler ticks and
    drains) and break fleet conservation."""
    rep = run(_fleet_spec(
        n_requests=40, rate=40.0,
        instances=[{"name": "a", "count": 1,
                    "topology": {"preset": "colocated", "n_replicas": 1}},
                   {"name": "b", "count": 1}],
        autoscaler={"min_instances": 1, "max_instances": 2,
                    "interval_s": 0.5},
        faults=[{"kind": "failure", "cluster": "colocated", "replica": 0,
                 "at": 0.0, "downtime": 1.0, "instance": "a"}]))
    assert rep.all_complete
    assert rep.conservation == {"complete": 40}
    # every registered request completed where it was routed
    for blk in rep.instances.values():
        assert blk["outstanding"] == 0
        assert blk["routed"] == blk["conservation"].get("complete", 0)


def test_pd_rebalance_leaves_inline_topologies_untouched():
    """Regression: spares are only bumped into pd-PRESET pools; an inline
    PD graph must keep every declared replica serving (parking its only
    prefill replica would deadlock arrivals)."""
    rep = run(_fleet_spec(
        n_requests=30,
        instances=[{"name": "inline", "count": 1,
                    "topology": {"preset": None, "clusters": [
                        {"name": "pre", "role": "prefill",
                         "n_replicas": 1},
                        {"name": "dec", "role": "decode",
                         "n_replicas": 1}]}}],
        autoscaler={"min_instances": 1, "max_instances": 1,
                    "interval_s": 0.5, "pd_rebalance": True,
                    "pd_spares": 1}))
    assert rep.all_complete
    assert rep.summary["rebalance_events"] == 0


# -------------------------------------------------------------- tenants --
def test_tenant_classes_and_slos():
    rep = run(_fleet_spec(
        n_requests=200,
        tenants=[{"name": "paid", "weight": 1, "ttft_s": 0.5},
                 {"name": "free", "weight": 3, "ttft_s": 2.0,
                  "priority": 1}]))
    assert rep.all_complete
    assert set(rep.tenants) == {"paid", "free"}
    n_paid = rep.tenants["paid"]["n_completed"]
    n_free = rep.tenants["free"]["n_completed"]
    assert n_paid + n_free == 200
    assert n_free > n_paid                      # 3:1 weighted draw
    for t in rep.tenants.values():
        assert t["slo_attainment"] is not None
    assert rep.summary["tenant_slo_attainment_min"] == min(
        t["slo_attainment"] for t in rep.tenants.values())


# --------------------------------------------------------- determinism --
def test_fleet_report_byte_identical_across_runs():
    spec = _fleet_spec(
        n_requests=120, router="power_of_two",
        instances=[{"name": "colo", "count": 2},
                   {"name": "pd", "count": 1,
                    "topology": {"preset": "pd"}}],
        autoscaler={"max_instances": 4, "interval_s": 0.5,
                    "up_queue_depth": 4.0},
        tenants=[{"name": "a", "weight": 1}, {"name": "b", "weight": 2}])

    def blob():
        d = run(SimSpec.from_dict(spec.to_dict())).to_dict()
        d.pop("wall_clock_s")
        d.pop("created_at")
        return json.dumps(d, sort_keys=True, default=float)

    assert blob() == blob()


# -------------------------------------------------------- windowed mode --
def _normalized_blob(spec_dict):
    """FleetReport JSON with the fields that legitimately differ between
    engine modes removed: provenance (spec/spec_hash embed the mode),
    mode-tagged summary keys, and sim_events (windowed mode fires one
    extra hand-off event per deferred arrival)."""
    d = run(SimSpec.from_dict(spec_dict)).to_dict()
    for k in ("wall_clock_s", "created_at", "spec", "spec_hash",
              "sim_events"):
        d.pop(k, None)
    d["summary"].pop("fleet_engine_mode", None)
    d["summary"].pop("fleet_window_s", None)
    return json.dumps(d, sort_keys=True, default=float)


def test_windowed_zero_window_matches_serial_on_golden_spec():
    import copy
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    from test_golden import SPECS
    serial = copy.deepcopy(SPECS["fleet_pd"])
    windowed = copy.deepcopy(SPECS["fleet_pd"])
    windowed["fleet"] = dict(windowed["fleet"], engine="windowed",
                             window_s=0.0)
    assert _normalized_blob(serial) == _normalized_blob(windowed)


def test_windowed_nonzero_window_is_deterministic_and_complete():
    import copy
    spec = _fleet_spec(
        n_requests=80, router="prefix_affinity",
        instances=[{"name": "colo", "count": 3}],
        autoscaler={"max_instances": 5, "interval_s": 0.5,
                    "up_queue_depth": 4.0}).to_dict()
    spec["fleet"] = dict(spec["fleet"], engine="windowed", window_s=0.2)
    a = _normalized_blob(copy.deepcopy(spec))
    b = _normalized_blob(copy.deepcopy(spec))
    assert a == b                        # deterministic given the window
    rep = run(SimSpec.from_dict(spec))
    assert rep.all_complete
    assert rep.summary["fleet_engine_mode"] == "windowed"
    assert rep.summary["fleet_window_s"] == 0.2


def test_fleet_engine_spec_validation():
    spec = _fleet_spec().to_dict()
    spec["fleet"]["engine"] = "threads"
    with pytest.raises(SpecError, match="engine"):
        SimSpec.from_dict(spec).validate()
    spec["fleet"]["engine"] = "windowed"
    spec["fleet"]["window_s"] = -1.0
    with pytest.raises(SpecError, match="window_s"):
        SimSpec.from_dict(spec).validate()


# ------------------------------------------------- conservation property --
def _check_conservation(preset, router, counts, n_requests, fault_at, seed):
    """Shared body: every arrived request ends complete on exactly one
    instance, fleet-wide, whatever the fleet shape / router / faults."""
    topo = {"preset": preset, "n_replicas": 2} if preset == "colocated" \
        else {"preset": preset, "n_prefill": 2, "n_decode": 2}
    instances = [{"name": "a", "count": counts[0], "topology": topo}]
    if counts[1]:
        instances.append({"name": "b", "count": counts[1]})
    faults = None
    if fault_at is not None:
        cluster = "colocated" if preset == "colocated" else "prefill"
        faults = [{"kind": "failure", "cluster": cluster, "replica": 0,
                   "at": fault_at, "downtime": 0.4, "instance": "a"}]
    rep = run(_fleet_spec(n_requests=n_requests, router=router,
                          instances=instances, faults=faults, seed=seed))
    assert rep.conservation == {"complete": n_requests}
    assert rep.all_complete
    # exactly-once: per-instance conservation sums to the fleet total and
    # every instance's requests completed where they were routed
    per_inst = [i["conservation"].get("complete", 0)
                for i in rep.instances.values()]
    assert sum(per_inst) == n_requests


@pytest.mark.parametrize("preset,router,fault_at", [
    ("colocated", "round_robin", None),
    ("pd", "prefix_affinity", 0.3),
    ("colocated", "power_of_two", 0.0),
    ("pd", "least_outstanding", 0.8),
])
def test_fleet_conservation_matrix(preset, router, fault_at):
    """Deterministic slice of the property below (runs without hypothesis)."""
    _check_conservation(preset, router, (2, 1), 30, fault_at, seed=1)


if HAVE_HYPOTHESIS:
    @settings(max_examples=12, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(
        preset=st.sampled_from(["colocated", "pd"]),
        router=st.sampled_from(sorted(FLEET_ROUTERS)),
        counts=st.tuples(st.integers(1, 2), st.integers(0, 2)),
        n_requests=st.integers(10, 40),
        fault_at=st.one_of(st.none(), st.floats(0.0, 1.0)),
        seed=st.integers(0, 3),
    )
    def test_fleet_wide_conservation(preset, router, counts, n_requests,
                                     fault_at, seed):
        """Over random fleets, routers, and fault injections: every
        arrived request completes exactly once across all instances."""
        _check_conservation(preset, router, counts, n_requests, fault_at,
                            seed)
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_fleet_wide_conservation():
        pass


# ------------------------------------------- the port against the reference --
def _both_blobs(spec_dict):
    """The same fleet spec through both packages: FleetReport JSON without
    the two provenance fields that name the moment of the run."""
    port = run(SimSpec.from_dict(spec_dict))
    ref = R.run(R.SimSpec.from_dict(spec_dict))
    assert isinstance(port, FleetReport) and isinstance(ref, RFleetReport)
    out = []
    for rep in (port, ref):
        d = json.loads(rep.to_json())
        d.pop("wall_clock_s")
        d.pop("created_at")
        out.append(json.dumps(d, sort_keys=True))
    return out


PARITY = {
    "golden_fleet_pd": None,       # tests/test_golden.py's fleet spec
    "autoscaled_power_of_two": dict(
        n_requests=120, router="power_of_two",
        instances=[{"name": "colo", "count": 2},
                   {"name": "pd", "count": 1, "topology": {"preset": "pd"}}],
        autoscaler={"max_instances": 4, "interval_s": 0.5,
                    "up_queue_depth": 4.0},
        tenants=[{"name": "a", "weight": 1}, {"name": "b", "weight": 2}]),
    "pd_rebalance": dict(
        n_requests=80, instances=[{"name": "pd", "count": 1,
                                   "topology": {"preset": "pd"}}],
        autoscaler={"max_instances": 2, "interval_s": 0.25,
                    "pd_rebalance": True, "pd_spares": 1}),
    "windowed_round_robin": dict(n_requests=60, router="round_robin"),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_fleet_report_equals_the_reference(case):
    if PARITY[case] is None:
        from test_golden import SPECS
        spec_dict = SPECS["fleet_pd"]
    else:
        spec_dict = _fleet_spec(**PARITY[case]).to_dict()
        if case.startswith("windowed"):
            spec_dict["fleet"]["engine"] = "windowed"
            spec_dict["fleet"]["window_s"] = 0.05
    port, ref = _both_blobs(spec_dict)
    assert port == ref


def test_sweep_of_fleet_points_returns_fleet_reports():
    """A sweep fanned out over worker processes rebuilds fleet points as
    FleetReports, equal to the in-process runs and to the reference's."""
    from repro_torch.api import sweep
    spec = _fleet_spec(n_requests=30)
    axes = {"fleet.router": ["round_robin", "power_of_two"]}
    serial = sweep(spec, axes, jobs=1, device="cpu")
    pooled = sweep(spec, axes, jobs=2, device="cpu")
    ref = R.sweep(R.SimSpec.from_dict(spec.to_dict()), axes, jobs=1)
    assert all(isinstance(r, FleetReport) for r in serial + pooled)
    for a, b, c in zip(serial, pooled, ref):
        assert a.summary == b.summary == c.summary
        assert a.point == b.point == c.point
