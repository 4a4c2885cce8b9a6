"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256; cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision].  Vision frontend is a stub:
``input_specs`` provides precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=False,
    cross_attn_every=5,
    n_image_tokens=1600,
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, cross_attn_every=2, n_image_tokens=16,
)
