"""Quickstart: simulate colocated vs PD-disaggregated serving of qwen2-7b.

Runs in seconds on CPU.  Shows the core Frontier workflow through the
declarative experiment API: describe the system as a `SimSpec`, `run` it,
read the typed `Report`.  The same specs serialize to JSON — see
`examples_torch/specs/quickstart.json` and `python -m repro_torch run`.

    PYTHONPATH=src python examples_torch/quickstart.py
"""
from repro_torch.api import ModelRef, SimSpec, TopologySpec, WorkloadSpec, run


def main():
    wl = WorkloadSpec(n_requests=200, rate=12.0, prompt_mean=1024,
                      output_mean=128)
    colo = SimSpec(name="colocated-2xTP1", model=ModelRef("qwen2-7b"),
                   topology=TopologySpec(preset="colocated", n_replicas=2,
                                         tp=1),
                   workload=wl, seed=0)
    pd = colo.with_(**{"name": "pd-1P1D",
                       "topology": {"preset": "pd", "n_prefill": 1,
                                    "n_decode": 1}})

    rep_c = run(colo)
    rep_p = run(pd)

    print(f"{'metric':28s} {'colocated(2xTP1)':>18s} {'PD(1P+1D)':>14s}")
    for k in ("throughput_tok_s_per_device", "ttft_p50_s", "ttft_p99_s",
              "tpot_p50_s", "tpot_p99_s", "e2e_p50_s", "queue_p99_s"):
        print(f"{k:28s} {rep_c[k]:18.4f} {rep_p[k]:14.4f}")
    print("\nPD decouples decode interactivity from long prefills "
          "(compare tpot_p99).")
    print(f"provenance: spec {rep_p.spec_hash}, {rep_p.sim_events} events "
          f"in {rep_p.wall_clock_s:.2f}s wall clock")


if __name__ == "__main__":
    main()
