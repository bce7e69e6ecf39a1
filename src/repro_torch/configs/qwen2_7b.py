"""qwen2-7b — the paper's own end-to-end evaluation model (Table 2).
[Qwen2 technical report 2024; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1_000_000.0,
)
