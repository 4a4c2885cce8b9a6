"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H vocab=102400;
MLA (kv_lora=512, rope 64 / nope 128 / v 128), 2 shared + 64 routed
top-6 experts (machine-readable spec field; see DESIGN.md section 9 on the
"160" comment discrepancy) [arXiv:2405.04434]."""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,               # dense layer 0 only
    vocab_size=102400,
    tie_embeddings=False,
    moe=MoEConfig(
        n_routed_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_expert=1408,
        n_dense_layers=1,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=512,
    moe=MoEConfig(n_routed_experts=8, n_shared_experts=1, top_k=2,
                  d_expert=32, n_dense_layers=1,
                  capacity_factor=4.0),  # drop-free at smoke scale
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
)
