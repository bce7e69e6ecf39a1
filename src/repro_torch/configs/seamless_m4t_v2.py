"""seamless-m4t-large-v2 — encoder-decoder multimodal (audio frontend stub).
[arXiv:2308.11596; hf]

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16), standard
(non-gated) FFN.  The speech frontend is a STUB: input_specs() provides
precomputed w2v-BERT-style frame embeddings (B, S_src, 1024).
vocab 256206 is padded to 256256 for 16-way TP (see base.padded_vocab).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,             # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    gated_mlp=False,
    mlp_act="relu",
    encoder_layers=24,
    cross_attention=True,
    frontend="frames",
    frontend_dim=1024,
    tie_embeddings=True,
)
