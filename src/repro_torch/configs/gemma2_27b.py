"""gemma2-27b — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig, ATTN_LOCAL, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    block_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norm=True,
    mlp_act="gelu",            # GeGLU
    tie_embeddings=True,
)
