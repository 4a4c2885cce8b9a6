"""gemma-7b [dense] — 28L d_model=3072 16H (MHA kv=16) d_ff=24576
vocab=256000; GeGLU, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    embed_scale=True,
    norm_scale_offset=True,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=16,
)
