"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064; QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
    vocab_size=512,
)
