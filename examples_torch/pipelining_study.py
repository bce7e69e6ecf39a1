"""Latency-hiding pipelining study (the paper's "advanced pipelining
strategies" tradeoff curves).

Two sweeps over the pipelining layer:

1. **AF decode overlap** — micro-batch count x overlap strategy for the
   af_moe preset: the serial (no-latency-hiding) baseline vs the legacy
   free-NIC model vs MegaScale-style two-batch ping-pong with NIC-lane
   contention and EP comm/compute overlap.  Reports step makespan,
   bubble_time, overlap_efficiency, and the per-cluster exposed-comm
   fractions — the quantities that decide whether AF disaggregation pays.

2. **Chunked prefill** — chunk size x strategy for a colocated pool:
   piggybacked decode bounds inter-token latency at the cost of prefill
   chunk turnaround (the Sarathi-Serve tradeoff).

    PYTHONPATH=src python examples_torch/pipelining_study.py
"""
from repro_torch.api import (
    ModelRef, PipelineSpec, SimSpec, TopologySpec, WorkloadSpec, run,
)


def af_overlap_study():
    base = SimSpec(
        model=ModelRef("mixtral-8x7b", smoke=True),
        topology=TopologySpec(preset="af", n_prefill=1, n_decode=1,
                              ffn_ep=4),
        workload=WorkloadSpec(n_requests=60, rate=25.0, prompt_mean=512,
                              output_mean=48, seed=0),
        name="af-overlap")

    print("== AF decode-step overlap: micro-batches x strategy ==")
    print(f"{'m':>3s} {'strategy':>12s} {'tpot_p50(ms)':>13s} "
          f"{'makespan(s)':>12s} {'bubble(s)':>10s} {'overlap_eff':>12s} "
          f"{'attn xcomm':>11s} {'ffn xcomm':>10s}")
    serial_makespans = {}
    for m in (1, 2, 4, 8):
        for strat in ("serial", None, "two_batch", "full_overlap"):
            spec = base.with_(**{"topology.m": m})
            if strat is not None:
                spec.pipeline = PipelineSpec(preset=strat)
            rep = run(spec)
            af = rep.clusters["decode"]["af"]
            label = strat or "off(legacy)"
            if strat == "serial":
                serial_makespans[m] = af["makespan_s"]
            print(f"{m:3d} {label:>12s} "
                  f"{rep['tpot_p50_s'] * 1e3:13.2f} "
                  f"{af['makespan_s']:12.4f} "
                  f"{rep.summary['bubble_time_s']:10.4f} "
                  f"{rep.summary['overlap_efficiency']:12.1%} "
                  f"{af['attn_exposed_comm_frac']:11.1%} "
                  f"{af['ffn_exposed_comm_frac']:10.1%}")
            if strat == "two_batch" and m > 1:
                assert af["makespan_s"] < serial_makespans[m], \
                    "two-batch overlap must beat the serial baseline"
    print("Reading: more micro-batches shrink bubbles until NIC-lane "
          "contention bites; ep_overlap (full_overlap) hides the a2a legs "
          "behind expert GEMMs.\n")


def chunked_prefill_study():
    base = SimSpec(
        model=ModelRef("qwen2-7b", smoke=True),
        topology=TopologySpec(preset="colocated", n_replicas=1),
        workload=WorkloadSpec(n_requests=80, rate=40.0, prompt_mean=2048,
                              output_mean=64, seed=0),
        name="chunked-prefill")

    print("== Chunked prefill with piggybacked decode: chunk size ==")
    print(f"{'chunk':>6s} {'ttft_p50(ms)':>13s} {'tpot_p99(ms)':>13s} "
          f"{'e2e_p50(s)':>11s} {'piggyback':>10s}")
    rep = run(base)
    print(f"{'off':>6s} {rep['ttft_p50_s'] * 1e3:13.1f} "
          f"{rep['tpot_p99_s'] * 1e3:13.2f} {rep['e2e_p50_s']:11.3f} "
          f"{'-':>10s}")
    for chunk in (128, 256, 512, 1024):
        spec = base.with_()
        spec.pipeline = PipelineSpec(chunked_prefill=True,
                                     prefill_chunk=chunk)
        rep = run(spec)
        piggy = sum(r.get("piggyback_tokens", 0)
                    for r in rep.clusters["colocated"]["replicas"].values())
        print(f"{chunk:6d} {rep['ttft_p50_s'] * 1e3:13.1f} "
              f"{rep['tpot_p99_s'] * 1e3:13.2f} {rep['e2e_p50_s']:11.3f} "
              f"{piggy:10d}")
    print("Reading: small chunks trade prefill turnaround (TTFT) for "
          "bounded inter-token latency under load.")


def main():
    af_overlap_study()
    chunked_prefill_study()


if __name__ == "__main__":
    main()
