"""Case study: replica failures and stragglers in a serving cluster.

Demonstrates the large-scale-operations machinery through the experiment
API: failure injection is data — a `FaultSpec` list on the `SimSpec` — so
the three what-if cases differ only in their fault lists and could equally
be three JSON specs run by `python -m repro_torch run`.

    PYTHONPATH=src python examples_torch/fault_tolerance_study.py
"""
from repro_torch.api import (FaultSpec, ModelRef, SimSpec, TopologySpec,
                       WorkloadSpec, run)

BASE = SimSpec(
    model=ModelRef("qwen2-7b"),
    topology=TopologySpec(preset="colocated", n_replicas=4, tp=1),
    workload=WorkloadSpec(n_requests=300, rate=40.0, prompt_mean=512,
                          output_mean=96),
    seed=0)

CASES = {
    "healthy x4": [],
    # replica 0 dies 1s in, recovers after 10s of downtime
    "1 failure (10s)": [FaultSpec(kind="failure", cluster="colocated",
                                  replica=0, at=1.0, downtime=10.0)],
    "1 straggler (3x)": [FaultSpec(kind="straggler", cluster="colocated",
                                   replica=1, slowdown=3.0)],
}


def main():
    reports = {}
    for name, faults in CASES.items():
        spec = SimSpec.from_dict(BASE.to_dict())
        spec.faults = faults
        rep = run(spec)
        reports[name] = rep
        print(f"{name:22s} tok/s {rep['throughput_tok_s']:8.0f}   "
              f"ttft_p99 {rep['ttft_p99_s']*1e3:8.1f} ms   "
              f"tpot_p99 {rep['tpot_p99_s']*1e3:7.1f} ms   "
              f"completed {rep['n_completed']}")
        assert rep.all_complete, rep.conservation

    base, f, s = (reports[k] for k in CASES)
    print(f"\nfailure throughput cost: "
          f"{1 - f['throughput_tok_s']/base['throughput_tok_s']:.1%}; "
          f"straggler cost: "
          f"{1 - s['throughput_tok_s']/base['throughput_tok_s']:.1%} "
          f"(all requests still complete — conservation holds)")


if __name__ == "__main__":
    main()
