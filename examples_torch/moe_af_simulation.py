"""MoE + AF disaggregation study (MegaScale-Infer / Step-3 style).

Sweeps the attention:FFN device ratio and micro-batch count for
mixtral-8x7b decode under skewed (Zipf) expert routing, reporting the
pipeline critical path, bubbles, and the per-EP-rank straggler penalty —
the phenomena Frontier's event-graph + micro-workflow models capture.
A second sweep moves expert ranks onto a *remote* cluster to show the
cross-cluster expert-routing penalty as a function of link bandwidth.

    PYTHONPATH=src python examples_torch/moe_af_simulation.py
"""
import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import A800_SXM4_80G, LinkSpec, ParallelismConfig
from repro_torch.core.opmodels.analytical import OperatorModelSet
from repro_torch.core.routing import resolve_router
from repro_torch.core.workflows.af_disagg import simulate_af_decode_step


def main():
    cfg = get_config("mixtral-8x7b")
    hw = A800_SXM4_80G
    ops = OperatorModelSet(hw)
    lens = [2048] * 256          # decode batch: 256 seqs @ 2k context

    print(f"{'attn:ffn':>9s} {'m':>3s} {'routing':>9s} {'step(ms)':>9s} "
          f"{'attn idle':>9s} {'ffn idle':>9s} {'straggler':>10s}")
    for n_attn, n_ffn in ((2, 6), (4, 4), (6, 2)):
        for m in (1, 2, 4):
            for rname in ("balanced", "zipf"):
                st = simulate_af_decode_step(
                    cfg, hw, ops, lens, m=m,
                    attn_par=ParallelismConfig(tp=n_attn),
                    ffn_par=ParallelismConfig(tp=1, ep=n_ffn),
                    routing=resolve_router(rname),
                    rng=np.random.default_rng(0))
                print(f"{n_attn}:{n_ffn:>7} {m:3d} {rname:>9s} "
                      f"{st.makespan*1e3:9.2f} {st.attn_bubble_frac:9.1%} "
                      f"{st.ffn_bubble_frac:9.1%} "
                      f"{st.ep_straggler_excess*1e3:8.2f}ms")
    print("\nReading: ffn-heavy ratios waste attention GPUs (idle%); "
          "zipf routing inflates the FFN stage via the straggler barrier.")

    # ---- cross-cluster expert routing: 2 of 8 EP ranks remote --------------
    print(f"\n{'expert link':>12s} {'step(ms)':>9s} {'xc MB/step':>11s} "
          f"{'straggler':>10s}")
    base = dict(m=2, attn_par=ParallelismConfig(tp=4),
                ffn_par=ParallelismConfig(tp=1, ep=8),
                routing=resolve_router("zipf"))
    for label, link in (("local", None),
                        ("100 GB/s", LinkSpec("decode", "exp", 100e9, 5e-6)),
                        ("25 GB/s", LinkSpec("decode", "exp", 25e9, 5e-6)),
                        ("5 GB/s", LinkSpec("decode", "exp", 5e9, 20e-6))):
        st = simulate_af_decode_step(
            cfg, hw, ops, lens, rng=np.random.default_rng(0),
            remote_ranks=(6, 7) if link else (), remote_link=link, **base)
        print(f"{label:>12s} {st.makespan*1e3:9.2f} "
              f"{st.cross_cluster_bytes/1e6:11.2f} "
              f"{st.ep_straggler_excess*1e3:8.2f}ms")
    print("\nReading: remote expert shards stretch dispatch/combine; below "
          "~25 GB/s the link, not the GroupedGEMM, gates the step.")


if __name__ == "__main__":
    main()
