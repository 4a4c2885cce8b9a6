"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304; alternating
mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar memory,
recurrent) blocks [arXiv:2405.04517]."""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                   # blocks carry their own projections
    vocab_size=50304,
    tie_embeddings=True,
    xlstm=XLSTMConfig(mlstm_expand=2, slstm_proj=4.0 / 3.0, conv_width=4,
                      chunk=256),
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, vocab_size=512,
    xlstm=XLSTMConfig(mlstm_expand=2, slstm_proj=4.0 / 3.0, conv_width=4,
                      chunk=16),
)
