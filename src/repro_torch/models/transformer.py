"""Block builders and per-architecture StackPlans (port of
``repro.models.transformer``).

This slice ports the plain dense decoder (qwen2 / qwen1.5-110b /
gemma-7b): one attention + gated-FFN block repeated ``n_layers`` times.
The other families raise ``NotImplementedError`` naming the slice of
ROADMAP queue 1 that ports them.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import attention, ffn, norms
from repro_torch.models.stack import BlockDef, Segment, StackPlan


def _norm(cfg, p, x):
    return norms.apply(p, x, eps=cfg.norm_eps,
                       scale_offset=cfg.norm_scale_offset)


def attn_ffn_block(cfg: ModelConfig, name: str, *, causal: bool = True,
                   window: int = 0,
                   rope_theta: Optional[float] = None) -> BlockDef:
    """Pre-norm self-attention + gated FFN block.  (The JAX builder's MoE,
    MLA, cross-attention and shared-block variants come with their
    families in slice 4.)"""

    def init(gen):
        ln1 = norms.init(gen, cfg.d_model, scale_offset=cfg.norm_scale_offset)
        at = attention.init(gen, cfg)
        ln2 = norms.init(gen, cfg.d_model, scale_offset=cfg.norm_scale_offset)
        mlp = ffn.init(gen, cfg.d_model, cfg.d_ff)
        params = {"ln1": ln1[0], "attn": at[0], "ln2": ln2[0], "mlp": mlp[0]}
        specs = {"ln1": ln1[1], "attn": at[1], "ln2": ln2[1], "mlp": mlp[1]}
        return params, specs

    def apply(p, x, state, ctx: Ctx):
        h = _norm(cfg, p["ln1"], x)
        h, new_state = attention.apply(
            p["attn"], h, state, ctx, cfg=cfg, causal=causal, window=window,
            rope_theta=rope_theta)
        x = x + h
        h2 = _norm(cfg, p["ln2"], x)
        return x + ffn.apply(p["mlp"], h2, ctx, act=cfg.act), new_state, 0.0

    def state_spec(batch, cache_len):
        return attention.state_spec(cfg, batch, cache_len)

    return BlockDef(name=name, init=init, apply=apply, state_spec=state_spec)


def build_plan(cfg: ModelConfig) -> StackPlan:
    """Backbone (decoder) plan.  Only the plain dense decoder is ported."""
    later = {
        "ssm": "the xlstm family (mLSTM/sLSTM, the ssd_scan kernel)",
        "hybrid": "the zamba2 family (mamba2, the ssd_scan kernel)",
    }
    if cfg.family in later:
        raise NotImplementedError(f"{later[cfg.family]} is ported in slice "
                                  "4 (ROADMAP queue 1)")
    for cond, what in ((cfg.moe is not None, "the deepseek MoE/MLA family"),
                       (cfg.cross_attn_every, "llama-3.2-vision's "
                        "cross-attention layers"),
                       (cfg.encdec, "whisper's encoder-decoder"),
                       (cfg.global_every, "gemma3's local/global layer "
                        "pattern")):
        if cond:
            raise NotImplementedError(f"{what} is ported in slice 4 "
                                      "(ROADMAP queue 1)")
    # plain dense decoder (qwen2 / qwen1.5-110b / gemma-7b)
    return StackPlan(segments=(
        Segment(pattern=(attn_ffn_block(cfg, "layer",
                                        window=cfg.sliding_window),),
                n_groups=cfg.n_layers),))


def build_encoder_plan(cfg: ModelConfig) -> Optional[StackPlan]:
    if not cfg.encdec:
        return None
    raise NotImplementedError("whisper's encoder-decoder is ported in slice "
                              "4 (ROADMAP queue 1)")
