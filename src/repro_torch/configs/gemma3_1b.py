"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; 5:1 local:global attention, 512-token window, dual rope
theta (1M global / 10k local) [hf:google/gemma-3-1b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    act="gelu",
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    sliding_window=512,
    global_every=6,
    embed_scale=True,
    norm_scale_offset=True,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=16, sliding_window=8, global_every=3,
)
