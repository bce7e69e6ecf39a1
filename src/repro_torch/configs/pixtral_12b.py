"""pixtral-12b — pixtral-ViT frontend (stub) + mistral-nemo-like backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

The modality frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings for the first frontend_fraction of the sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_dim=5120,
    frontend_fraction=0.25,
)
