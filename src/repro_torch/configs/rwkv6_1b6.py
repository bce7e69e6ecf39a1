"""rwkv6-1.6b (Finch) — attention-free RNN with data-dependent decay.
[arXiv:2404.05892; unverified]

Attention-free => constant-size recurrent state => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, RWKV

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # wkv heads = d_model / rwkv_head_size
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=(RWKV,),
    gated_mlp=False,           # rwkv channel-mix is its own 2-layer relu^2 FFN
    rwkv_head_size=64,
    tie_embeddings=False,
)
