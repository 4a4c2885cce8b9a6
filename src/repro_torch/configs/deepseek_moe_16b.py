"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) vocab=102400;
fine-grained MoE: 2 shared + 64 routed experts, top-6, expert hidden 1408
(the spec's ``d_ff``); the single leading dense layer uses the paper's
10944 FFN [arXiv:2401.06066]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,               # dense layer 0 only; experts use moe.d_expert
    vocab_size=102400,
    tie_embeddings=False,
    moe=MoEConfig(
        n_routed_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_expert=1408,
        n_dense_layers=1,
    ),
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=512,
    moe=MoEConfig(n_routed_experts=8, n_shared_experts=1, top_k=2,
                  d_expert=32, n_dense_layers=1,
                  capacity_factor=4.0),  # drop-free at smoke scale
)
