"""Memory & KV-cache study: prefix caching, preemption, streamed transfer.

Three sweeps over the first-class memory subsystem (PR: KVCacheManager +
preemption/restore + layer-wise streamed KV transfer):

1. **Prefix caching under pressure** — cache size (``capacity_frac``) x
   prefix-share ratio for a PD system on a shared-system-prompt fleet:
   the radix prefix cache reports its hit-token fraction and beats the
   plain paged manager on tail TTFT because cached prefill compute is
   skipped.

2. **Layer-wise streamed KV transfer** — transfer overlap x preset
   (PD / AF): per-layer KV chunks pipeline behind remaining prefill
   layers, shrinking the exposed-transfer fraction; ``overlap=0``
   reproduces the legacy lump-sum timings bit-for-bit.

3. **Preemption policies** — decode OOM under shrinking cache sizes:
   recompute vs swap restore, with zero stalled/leaked requests and block
   conservation at every point (also run colocated for coverage).

    PYTHONPATH=src python examples_torch/memory_pressure_study.py
"""
from repro_torch.api import SimSpec, run


def _pd_spec(**overrides):
    d = {
        "model": {"name": "qwen2-7b", "smoke": True},
        "topology": {"preset": "pd", "n_prefill": 1, "n_decode": 1},
        "workload": {"n_requests": 60, "rate": 120.0, "prompt_mean": 512,
                     "output_mean": 32, "seed": 5},
        "seed": 5,
        "name": "memory-study",
    }
    d.update(overrides)
    return SimSpec.from_dict(d)


def prefix_caching_study():
    print("== Prefix caching under memory pressure (PD, shared prompts) ==")
    print(f"{'manager':>8s} {'cap_frac':>9s} {'groups':>7s} "
          f"{'hit_frac':>9s} {'ttft_p99(ms)':>13s} {'prefill_toks':>13s}")
    for cap in (0.01, 0.001):
        for groups in (2, 8):
            base_wl = {"n_requests": 60, "rate": 120.0, "prompt_mean": 512,
                       "output_mean": 32, "prefix_groups": groups,
                       "prefix_len": 2048, "seed": 5}
            reps = {}
            for mgr in ("paged", "prefix"):
                spec = _pd_spec(
                    workload=base_wl,
                    memory={"manager": mgr, "capacity_frac": cap})
                reps[mgr] = run(spec)
                assert reps[mgr].all_complete, reps[mgr].conservation
                hit = reps[mgr].summary.get("prefix_hit_token_frac")
                toks = sum(
                    r["prefill_tokens"] for r in
                    reps[mgr].clusters["prefill"]["replicas"].values())
                print(f"{mgr:>8s} {cap:9.4f} {groups:7d} "
                      f"{'-' if hit is None else f'{hit:.1%}':>9s} "
                      f"{reps[mgr]['ttft_p99_s'] * 1e3:13.2f} {toks:13d}")
            assert reps["prefix"].summary["prefix_hit_token_frac"] > 0, \
                "shared-prefix workload must produce cache hits"
            assert reps["prefix"]["ttft_p99_s"] <= reps["paged"]["ttft_p99_s"], \
                "prefix caching must not lose on tail TTFT under pressure"
    print("Reading: fewer prompt groups -> hotter prefixes -> higher hit "
          "fractions; skipped prefill compute shows up directly in tail "
          "TTFT.\n")


def streamed_transfer_study():
    print("== Layer-wise streamed KV transfer: overlap x preset ==")
    print(f"{'preset':>6s} {'overlap':>8s} {'exposed_frac':>13s} "
          f"{'exposed(ms)':>12s} {'serial(ms)':>11s}")
    for preset, model in (("pd", "qwen2-7b"), ("af", "mixtral-8x7b")):
        legacy = None
        for ov in (0.0, 0.5, 1.0):
            spec = _pd_spec(
                model={"name": model, "smoke": True},
                topology={"preset": preset, "n_prefill": 1, "n_decode": 1},
                memory={"manager": "paged", "transfer_overlap": ov})
            rep = run(spec)
            assert rep.all_complete
            s = rep.summary
            print(f"{preset:>6s} {ov:8.1f} "
                  f"{s['kv_transfer_exposed_frac']:13.1%} "
                  f"{s['kv_transfer_exposed_s'] * 1e3:12.3f} "
                  f"{s['kv_transfer_serial_s'] * 1e3:11.3f}")
            if ov == 0.0:
                legacy = _pd_spec(
                    model={"name": model, "smoke": True},
                    topology={"preset": preset, "n_prefill": 1,
                              "n_decode": 1})
                lump = run(legacy)
                same = {k: v for k, v in rep.summary.items()
                        if not k.startswith("kv_transfer")}
                lump_cmp = {k: v for k, v in lump.summary.items()
                            if not k.startswith("kv_transfer")}
                assert same == lump_cmp, \
                    "overlap=0 must reproduce legacy timings bit-for-bit"
                assert s["kv_transfer_exposed_frac"] == 1.0
            else:
                assert s["kv_transfer_exposed_frac"] < 1.0, \
                    "streaming must hide part of the transfer"
    print("Reading: streaming hides all but the last layer's chunk; the "
          "AF preset moves less KV per token, so its absolute win is "
          "smaller.\n")


def preemption_study():
    print("== Preemption/restore: recompute vs swap across cache sizes ==")
    print(f"{'preset':>9s} {'policy':>10s} {'cap_frac':>9s} "
          f"{'preempts':>9s} {'swaps':>6s} {'e2e_p99(s)':>11s} "
          f"{'complete':>9s}")
    wl = {"n_requests": 40, "arrival": "burst", "burst_size": 40,
          "burst_period": 1.0, "prompt": "fixed", "prompt_mean": 64,
          "output": "fixed", "output_mean": 2048, "seed": 7}
    for preset in ("pd", "colocated"):
        topo = {"preset": preset}
        if preset == "pd":
            topo.update(n_prefill=1, n_decode=1)
        decode_cluster = "decode" if preset == "pd" else "colocated"
        for mode in ("recompute", "swap"):
            for cap in (0.001, 0.0002):
                spec = _pd_spec(
                    topology=topo, workload=wl, seed=7,
                    memory={"manager": "paged", "capacity_frac": cap,
                            "preemption": mode})
                rep = run(spec)
                # zero stalled/leaked requests, whatever the pressure
                assert rep.all_complete, (preset, mode, cap,
                                          rep.conservation)
                mem = rep.clusters[decode_cluster]["memory"]
                print(f"{preset:>9s} {mode:>10s} {cap:9.4f} "
                      f"{rep.summary['preemptions']:9d} "
                      f"{mem['swap_outs']:6d} "
                      f"{rep['e2e_p99_s']:11.2f} "
                      f"{str(rep.all_complete):>9s}")
    print("Reading: swap trades PCIe restore time for recompute FLOPs — "
          "under tight memory both finish, with different tail latency "
          "costs.")


def main():
    prefix_caching_study()
    streamed_transfer_study()
    preemption_study()


if __name__ == "__main__":
    main()
