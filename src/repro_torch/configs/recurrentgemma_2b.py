"""recurrentgemma-2b (Griffin) — RG-LRU recurrent blocks + local attention, 1:2.
[arXiv:2402.19427; hf]

Pattern: (recurrent, recurrent, local-attn) cycled over 26 layers.
10 heads x head_dim 256 = 2560.  10 is not divisible by the 16-way model axis
=> attention runs replicated on the model axis (documented in DESIGN.md);
the recurrent blocks and MLP shard on channels.
Sub-quadratic (RG-LRU state + 2048-token local window) => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, RECURRENT, ATTN_LOCAL

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=(RECURRENT, RECURRENT, ATTN_LOCAL),
    sliding_window=2048,
    mlp_act="gelu",
    tie_embeddings=True,
    conv1d_width=4,
)
