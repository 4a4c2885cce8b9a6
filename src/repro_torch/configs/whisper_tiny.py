"""whisper-tiny [audio] — enc-dec, 4+4L d_model=384 6H d_ff=1536
vocab=51865; conv frontend is a STUB (``input_specs`` provides
precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    tie_embeddings=True,
    encdec=True,
    n_enc_layers=4,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, n_enc_layers=2,
)
