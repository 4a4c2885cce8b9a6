"""Block builders and per-architecture StackPlans (port of
``repro.models.transformer``).

Ported: the plain dense decoder (qwen2 / qwen1.5-110b / gemma-7b: one
attention + gated-FFN block repeated ``n_layers`` times) and the hybrid
family (zamba2: groups of Mamba-2 blocks, each group closed by one
weight-shared attention block, then a tail of Mamba-2 blocks).  The
other families raise ``NotImplementedError`` naming the item of ROADMAP
queue 1 that ports them.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import attention, ffn, mamba2, norms
from repro_torch.models.stack import BlockDef, Segment, StackPlan


def _norm(cfg, p, x):
    return norms.apply(p, x, eps=cfg.norm_eps,
                       scale_offset=cfg.norm_scale_offset)


def attn_ffn_block(cfg: ModelConfig, name: str, *, causal: bool = True,
                   window: int = 0,
                   rope_theta: Optional[float] = None,
                   use_extra: bool = False) -> BlockDef:
    """Pre-norm self-attention + gated FFN block; with ``use_extra`` its
    parameters are the plan's shared (unstacked) ones, its state per
    group.  (The JAX package's MoE, MLA and cross-attention variants come
    with their families, ROADMAP queue 1 item 12.)"""

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

    return BlockDef(name=name, init=init, apply=apply, state_spec=state_spec,
                    use_extra=use_extra)


def mamba_block(cfg: ModelConfig, name: str) -> BlockDef:
    """Pre-norm Mamba-2 mixer block with a residual."""

    def init(gen):
        ln = norms.init(gen, cfg.d_model)
        mx = mamba2.init(gen, cfg)
        return {"ln": ln[0], "mix": mx[0]}, {"ln": ln[1], "mix": mx[1]}

    def apply(p, x, state, ctx: Ctx):
        h, new_state = mamba2.apply(p["mix"], _norm(cfg, p["ln"], x),
                                    state, ctx, cfg=cfg)
        return x + h, new_state, 0.0

    return BlockDef(name=name, init=init, apply=apply,
                    state_spec=lambda b, c: mamba2.state_spec(cfg, b, c))


LATER = "is ported by ROADMAP queue 1 item 12 (the other model families)"


def build_plan(cfg: ModelConfig) -> StackPlan:
    """Backbone (decoder) plan: the dense decoder and the hybrid family."""
    if cfg.family == "ssm":
        raise NotImplementedError("the xlstm family (mLSTM with a P = N + 1 "
                                  f"state, the sLSTM recurrence) {LATER}")
    if cfg.family == "hybrid":  # zamba2: mamba + shared attn every k
        k = cfg.shared_attn_every
        shared = attn_ffn_block(cfg, "shared_attn", use_extra=True)
        n_groups, tail = divmod(cfg.n_layers, k)
        pattern = tuple(mamba_block(cfg, f"mamba{i}") for i in range(k)) \
            + (shared,)
        segs = [Segment(pattern=pattern, n_groups=n_groups)]
        if tail:
            segs.append(Segment(
                pattern=tuple(mamba_block(cfg, f"tail_mamba{i}")
                              for i in range(tail)), n_groups=1))
        return StackPlan(segments=tuple(segs), extra_blocks=(shared,))
    for cond, what in ((cfg.moe is not None, "the deepseek MoE/MLA family"),
                       (cfg.cross_attn_every, "llama-3.2-vision's "
                        "cross-attention layers"),
                       (cfg.encdec, "whisper's encoder-decoder"),
                       (cfg.global_every, "gemma3's local/global layer "
                        "pattern")):
        if cond:
            raise NotImplementedError(f"{what} {LATER}")
    # plain dense decoder (qwen2 / qwen1.5-110b / gemma-7b)
    return StackPlan(segments=(
        Segment(pattern=(attn_ffn_block(cfg, "layer",
                                        window=cfg.sliding_window),),
                n_groups=cfg.n_layers),))


def build_encoder_plan(cfg: ModelConfig) -> Optional[StackPlan]:
    if not cfg.encdec:
        return None
    raise NotImplementedError(f"whisper's encoder-decoder {LATER}")
