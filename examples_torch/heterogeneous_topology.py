"""Heterogeneous StageGraph topologies in one-liners.

What used to require a bespoke builder is now a declarative graph:

1. PD front on A800 + AF-disaggregated MoE decode on H100, with two of
   eight EP ranks hosted on a remote A800 expert cluster reached over an
   asymmetric inter-cluster link (cross-cluster expert routing);
2. the same system with TWO decode pools of different hardware, fed by one
   prefill cluster — the controller picks the least-loaded pool with free
   KV memory per transfer.

    PYTHONPATH=src python examples_torch/heterogeneous_topology.py
"""
from repro_torch.configs import get_config
from repro_torch.core import (
    A800_SXM4_80G, H100_SXM, ClusterSpec, LinkSpec, ParallelismConfig,
    StageGraph, build_system,
)
from repro_torch.workload.generator import WorkloadConfig, generate


def pd_af_cross_cluster(cfg):
    return StageGraph(
        clusters=[
            ClusterSpec("prefill", "prefill", n_replicas=2,
                        par=ParallelismConfig(tp=2)),
            ClusterSpec("decode", "decode", step="af", m=2,
                        hardware=H100_SXM,
                        par=ParallelismConfig(tp=2),
                        attn_par=ParallelismConfig(tp=2),
                        ffn_par=ParallelismConfig(tp=1, ep=8),
                        remote_expert_ranks=(6, 7),
                        expert_cluster_hw=A800_SXM4_80G,
                        expert_link=LinkSpec("decode", "experts",
                                             bandwidth=25e9, latency=5e-6),
                        seed_offset=50),
        ],
        links=[LinkSpec("prefill", "decode", bandwidth=50e9),
               LinkSpec("decode", "prefill", bandwidth=25e9)])


def two_decode_pools(cfg):
    return StageGraph(
        clusters=[
            ClusterSpec("prefill", "prefill", n_replicas=1,
                        par=ParallelismConfig(tp=2)),
            ClusterSpec("decode-h100", "decode", hardware=H100_SXM,
                        par=ParallelismConfig(tp=2), seed_offset=100),
            ClusterSpec("decode-a800", "decode",
                        par=ParallelismConfig(tp=2), seed_offset=200),
        ],
        links=[LinkSpec("prefill", "decode-h100", bandwidth=50e9),
               LinkSpec("prefill", "decode-a800", bandwidth=25e9)])


def main():
    mcfg = get_config("mixtral-8x7b")
    cfg = get_config("qwen2-7b")
    wl = WorkloadConfig(n_requests=60, rate=15.0, prompt_mean=512,
                        output_mean=32, seed=0)

    sys = build_system(mcfg, A800_SXM4_80G, pd_af_cross_cluster(mcfg),
                       routing="zipf")
    rep = sys.run(generate(wl))
    pred = sys.clusters["decode"].replicas[0].predictor
    st = pred.last_stats
    print("1) PD front + AF decode (H100) + cross-cluster EP (A800):")
    print(f"   completed={rep['n_completed']}  "
          f"tok/s/dev={rep['throughput_tok_s_per_device']:.1f}  "
          f"tpot_p50={rep['tpot_p50_s']*1e3:.1f}ms")
    print(f"   last decode step: straggler={st.ep_straggler_excess*1e3:.2f}ms"
          f"  cross-cluster={st.cross_cluster_bytes/1e6:.2f}MB"
          f"  ffn idle={st.ffn_bubble_frac:.1%}")

    sys = build_system(cfg, A800_SXM4_80G, two_decode_pools(cfg))
    rep = sys.run(generate(wl))
    print("\n2) one prefill cluster feeding two heterogeneous decode pools:")
    print(f"   completed={rep['n_completed']}  "
          f"tpot_p50={rep['tpot_p50_s']*1e3:.1f}ms")
    for name in ("decode-h100", "decode-a800"):
        toks = sum(w.stats["tokens"] for w in sys.clusters[name].replicas)
        print(f"   {name}: {toks} tokens decoded")


if __name__ == "__main__":
    main()
