"""Fleet capacity study: router x instance-count x autoscaler under
diurnal load.

Sweeps the global routing policy, the provisioned fleet size, and
whether the SLO-driven autoscaler may resize the fleet, over a
shared-prefix diurnal workload — the capacity-planning question a fleet
operator actually asks: how few GPUs hold the SLO through the daily
peak, and how much does cache-aware routing buy?

    PYTHONPATH=src python examples_torch/fleet_capacity_study.py
"""
import json
import os

from repro_torch.api import SimSpec, sweep

SMOKE = bool(int(os.environ.get("SMOKE", "1")))


def instance_groups(n: int):
    """A heterogeneous fleet of n instances: 3/4 colocated, 1/4 PD."""
    return [
        {"name": "colo", "count": n - n // 4},
        {"name": "pd", "count": n // 4,
         "topology": {"preset": "pd", "n_prefill": 1, "n_decode": 1}},
    ]


def main():
    base = SimSpec.from_dict({
        "name": "fleet-capacity",
        "model": {"name": "qwen2-7b", "smoke": True},
        "topology": {"preset": "colocated"},
        "workload": {"n_requests": 600 if SMOKE else 5000, "rate": 200.0,
                     "rate_curve": "diurnal", "rate_period": 20.0,
                     "rate_amplitude": 0.7, "prompt_mean": 256,
                     "output_mean": 32, "prefix_groups": 12,
                     "prefix_len": 256, "seed": 0},
        "memory": {"manager": "prefix"},
        "slo": {"ttft_s": 0.5, "tpot_s": 0.05},
        "fleet": {"instances": instance_groups(4),
                  "router": "least_outstanding"},
        "seed": 0,
    })
    autoscaler = {"min_instances": 2, "max_instances": 24,
                  "interval_s": 1.0, "cooldown_s": 2.0,
                  "up_queue_depth": 8.0, "down_queue_depth": 1.0,
                  "slo_attainment_floor": 0.9, "provision_bw": 64e9,
                  "startup_base_s": 1.0}
    axes = {
        "fleet.router": ["round_robin", "least_outstanding",
                         "power_of_two", "prefix_affinity"],
        "fleet.instances": [instance_groups(4), instance_groups(8)],
        "fleet.autoscaler": [None, autoscaler],
    }
    reports = sweep(base, axes, jsonl="artifacts/fleet_capacity.jsonl")

    hdr = (f"{'router':18s} {'inst':>4s} {'auto':>5s} {'ttft_p99':>9s} "
           f"{'slo':>6s} {'hit%':>6s} {'imbal':>6s} {'idle_gpu_s':>10s} "
           f"{'scale':>6s}")
    print("\n" + hdr + "\n" + "-" * len(hdr))
    for rep in reports:
        p = rep.point
        n0 = sum(g["count"] for g in p["fleet.instances"])
        auto = p["fleet.autoscaler"] is not None
        s = rep.summary
        hit = s.get("prefix_hit_token_frac")
        print(f"{p['fleet.router']:18s} {n0:4d} {str(auto):>5s} "
              f"{s['ttft_p99_s']:9.4f} {s.get('slo_attainment', 0):6.3f} "
              f"{'' if hit is None else f'{100 * hit:6.2f}'} "
              f"{s.get('routing_imbalance') or 0:6.3f} "
              f"{s['idle_gpu_seconds']:10.1f} "
              f"{s['scale_up_events'] + s['scale_down_events']:6d}")

    # the cache-aware routing headline: fleet prefix-hit rate by router
    # (static 4-instance fleet, apples to apples)
    print("\nPrefix-cache hit rate by router (4 instances, no autoscaler):")
    for rep in reports:
        p = rep.point
        if p["fleet.autoscaler"] is None \
                and sum(g["count"] for g in p["fleet.instances"]) == 4:
            print(f"  {p['fleet.router']:18s} "
                  f"{100 * rep.summary['prefix_hit_token_frac']:.2f}%")
    os.makedirs("artifacts", exist_ok=True)
    with open("artifacts/fleet_capacity_points.json", "w") as f:
        json.dump([{"point": r.point, "summary": r.summary}
                   for r in reports], f, indent=2, default=float)
    print("\nreports -> artifacts/fleet_capacity.jsonl")


if __name__ == "__main__":
    main()
