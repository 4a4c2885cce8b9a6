"""zamba2-1.2b [hybrid] — 38 Mamba-2 layers d_model=2048, ssm_state=64,
plus one weight-SHARED attention block (32H kv=32, d_ff=8192) applied
every 6th layer [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,                # the shared attention block's MLP
    vocab_size=32000,
    tie_embeddings=True,
    shared_attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, d_conv=4, chunk=256),
)

REDUCED = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, shared_attn_every=3,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, d_conv=4, chunk=32),
)
