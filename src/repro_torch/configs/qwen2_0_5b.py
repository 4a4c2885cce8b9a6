"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936; GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16,
)
