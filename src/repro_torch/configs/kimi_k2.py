"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8.
[arXiv:2501.kimi2 paper-table; unverified]

Per the assignment table: GQA kv=8 (the real model uses MLA; the assigned
spec is authoritative here), per-expert d_ff=2048.
head_dim = 7168/64 = 112.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,                 # per-expert width
    vocab_size=163840,
    head_dim=112,
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=384, top_k=8, expert_d_ff=2048,
                  num_shared_experts=1),
)
