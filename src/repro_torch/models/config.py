"""Model configuration system (port of ``repro.models.config``; pure
dataclasses, copied whole).

One frozen dataclass covers the ten assigned architectures; families are
expressed through optional sub-configs (MoE, MLA, SSM, enc-dec, VLM) plus a
repeating ``block pattern`` that the layer stack (``stack.py``) runs as
a loop over groups of stacked parameters.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    top_k: int = 6
    d_expert: int = 1408           # fine-grained expert hidden size
    n_dense_layers: int = 1        # leading dense-FFN layers (deepseek style)
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25  # per-expert buffer slack for dispatch


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 = direct q projection (v2-lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64            # N: SSD state size
    head_dim: int = 64             # P: channels per SSD head
    expand: int = 2                # d_inner = expand * d_model
    d_conv: int = 4                # causal conv width
    chunk: int = 256               # chunked-scan block length


@dataclass(frozen=True)
class XLSTMConfig:
    mlstm_expand: int = 2          # mLSTM inner expansion
    slstm_proj: float = 4.0 / 3.0  # sLSTM post-FFN expansion
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"              # silu -> SwiGLU, gelu -> GeGLU
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0  # gemma3: local layers use a different theta
    norm_eps: float = 1e-6
    norm_scale_offset: bool = False  # gemma: RMSNorm applies (1 + w)
    embed_scale: bool = False        # gemma: embeddings scaled by sqrt(D)
    tie_embeddings: bool = True

    # local/global interleave (gemma3: window on 5 of 6 layers)
    sliding_window: int = 0        # 0 -> full attention
    global_every: int = 0          # every k-th layer is global (0 -> none)

    # family sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # hybrid (zamba2): shared attention block applied every k SSM layers
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    encdec: bool = False
    n_enc_layers: int = 0

    # VLM (llama-3.2-vision): cross-attn layer every k layers
    cross_attn_every: int = 0
    n_image_tokens: int = 0

    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / linear-attn)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for roofline MODEL_FLOPS = 6 N D) ----
    def param_count(self, active_only: bool = False) -> int:
        D = self.d_model
        Dh = self.resolved_head_dim
        H, Hkv = self.n_heads, self.n_kv_heads
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * D * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                p = D * (m.kv_lora_rank + m.rope_head_dim)           # down kv
                p += m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
                qin = m.q_lora_rank or D
                p += (D * m.q_lora_rank if m.q_lora_rank else 0)
                p += qin * H * (m.nope_head_dim + m.rope_head_dim)
                p += H * m.v_head_dim * D                             # o
                return p
            p = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
            if self.qkv_bias:
                p += (H + 2 * Hkv) * Dh
            return p

        def ffn_params(dff: int) -> int:
            return 3 * D * dff  # gated (in, gate, out)

        def ssm_params() -> int:
            s = self.ssm or SSMConfig()
            d_in = s.expand * D
            nh = d_in // s.head_dim
            p = D * (2 * d_in + 2 * s.state_dim + nh)  # in_proj(z,x) + B,C + dt
            p += d_in * s.d_conv + d_in * D            # conv + out proj
            return p

        def mlstm_params() -> int:
            x = self.xlstm or XLSTMConfig()
            d_in = x.mlstm_expand * D
            return D * d_in * 2 + d_in * 3 * d_in // x.mlstm_expand + d_in * D

        def slstm_params() -> int:
            x = self.xlstm or XLSTMConfig()
            dp = int(D * x.slstm_proj)
            return 4 * D * D + 4 * D * D + 2 * D * dp  # gates(x) + gates(h) + ffn

        if self.family == "ssm":
            for i in range(self.n_layers):
                n += mlstm_params() if i % 2 == 0 else slstm_params()
        elif self.family == "hybrid":
            n += self.n_layers * ssm_params()
            if self.shared_attn_every:
                n += attn_params() + ffn_params(self.d_ff)  # shared weights, once
        else:
            per_layer_dense = attn_params() + ffn_params(self.d_ff)
            if self.moe is not None:
                m = self.moe
                moe_ffn_total = (
                    m.n_shared_experts * 3 * D * m.d_expert
                    + m.n_routed_experts * 3 * D * m.d_expert
                    + D * m.n_routed_experts  # router
                )
                moe_ffn_active = (
                    m.n_shared_experts * 3 * D * m.d_expert
                    + m.top_k * 3 * D * m.d_expert
                    + D * m.n_routed_experts
                )
                n_moe = self.n_layers - m.n_dense_layers
                n += m.n_dense_layers * per_layer_dense
                n += n_moe * (attn_params()
                              + (moe_ffn_active if active_only else moe_ffn_total))
            else:
                n += self.n_layers * per_layer_dense
            if self.encdec:
                # encoder layers + decoder cross-attn
                n += self.n_enc_layers * (attn_params() + ffn_params(self.d_ff))
                n += self.n_layers * attn_params()  # cross-attn per dec layer
            if self.cross_attn_every:
                n_cross = self.n_layers // self.cross_attn_every
                n += n_cross * (attn_params() + ffn_params(self.d_ff))
        return n


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    phase: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, per the brief's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention (skip per brief)")
    return True, ""
