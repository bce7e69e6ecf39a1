"""qwen3-32b — dense, qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B family; hf]

HF-faithful head_dim=128 (so q-proj is 5120 -> 64*128=8192).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
