"""Design-space exploration: throughput/interactivity Pareto frontier.

The motivating use-case of the paper — finding the optimal serving config
without burning 18,000 GPU-hours.  Sweeps (topology x parallelism x
batching policy) for qwen2-7b on a 16-GPU budget with the declarative
sweep API: the whole study is one `sweep()` over a topology/policy axis,
fanned out across processes, and `pareto()` reads the frontier.

    PYTHONPATH=src python examples_torch/pareto_sweep.py [--jobs N]
"""
import argparse

from repro_torch.api import ModelRef, SimSpec, WorkloadSpec, pareto, sweep

BUDGET = 16   # devices


def candidate_axes():
    """Zip-mode axes: (topology, batching policy) pairs per candidate."""
    topologies, batchings, names = [], [], []
    for tp in (1, 2, 4):
        n = BUDGET // tp
        for pol in ("cont", "chunked"):
            topologies.append({"preset": "colocated", "n_replicas": n,
                               "tp": tp})
            batchings.append({"name": "continuous"} if pol == "cont" else
                             {"name": "chunked_prefill", "chunk": 512})
            names.append(f"colo x{n} tp{tp} {pol}")
    for n_p in (4, 8, 12):
        topologies.append({"preset": "pd", "n_prefill": n_p,
                           "n_decode": BUDGET - n_p})
        batchings.append(None)     # role defaults
        names.append(f"pd {n_p}P:{BUDGET - n_p}D")
    return topologies, batchings, names


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args()

    base = SimSpec(model=ModelRef("qwen2-7b"),
                   workload=WorkloadSpec(n_requests=150, rate=25.0,
                                         prompt_mean=1024, output_mean=128),
                   seed=0)
    topologies, batchings, names = candidate_axes()
    reports = sweep(base, {"topology": topologies,
                           "policy.batching": batchings},
                    mode="zip", jobs=args.jobs)

    print(f"{'config':24s} {'tok/s/dev':>10s} {'tpot_p50(ms)':>13s} "
          f"{'ttft_p99(ms)':>13s}")
    for name, rep in zip(names, reports):
        print(f"{name:24s} {rep['throughput_tok_s_per_device']:10.1f} "
              f"{rep['tpot_p50_s'] * 1e3:13.2f} "
              f"{rep['ttft_p99_s'] * 1e3:13.1f}")

    front = pareto(reports)
    print("\nPareto frontier (throughput x interactivity):")
    for rep in front:
        print("  *", names[reports.index(rep)])


if __name__ == "__main__":
    main()
