"""mixtral-8x7b — 8 experts top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]

SWA(4096) bounds the decode KV window => sub-quadratic => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN_LOCAL

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    block_pattern=(ATTN_LOCAL,),
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=14336),
)
