"""Block builders and per-architecture StackPlans (port of
``repro.models.transformer``).

Ported: the dense decoders (qwen2 / qwen1.5-110b / gemma-7b: one
attention + gated-FFN block repeated; gemma3: windowed local layers with
their own rope theta, every ``global_every``-th layer global, then a tail
of locals), the hybrid family (zamba2: groups of Mamba-2 blocks, each
closed by one weight-shared attention block, then a tail of Mamba-2
blocks), the xLSTM family (alternating mLSTM / sLSTM blocks) and the
DeepSeek family (leading dense layers, then MoE layers; MLA attention
where the config has it).  whisper's encoder-decoder and
llama-3.2-vision's cross-attention raise ``NotImplementedError`` naming
the item of ROADMAP queue 1 that ports them.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import (attention, ffn, mamba2, mla, moe,
                                       norms, xlstm)
from repro_torch.models.stack import BlockDef, Segment, StackPlan


def _norm(cfg, p, x):
    return norms.apply(p, x, eps=cfg.norm_eps,
                       scale_offset=cfg.norm_scale_offset)


def attn_ffn_block(cfg: ModelConfig, name: str, *, causal: bool = True,
                   window: int = 0,
                   rope_theta: Optional[float] = None,
                   use_moe: bool = False, use_mla: bool = False,
                   use_extra: bool = False) -> BlockDef:
    """Pre-norm self-attention (or MLA) + gated FFN (or MoE) block; with
    ``use_extra`` its parameters are the plan's shared (unstacked) ones,
    its state per group.  (The JAX package's cross-attention variant
    comes with whisper and llama-3.2-vision, ROADMAP queue 1 item 12.)"""

    def init(gen):
        ln1 = norms.init(gen, cfg.d_model, scale_offset=cfg.norm_scale_offset)
        at = mla.init(gen, cfg) if use_mla else attention.init(gen, cfg)
        ln2 = norms.init(gen, cfg.d_model, scale_offset=cfg.norm_scale_offset)
        mlp = moe.init(gen, cfg) if use_moe else \
            ffn.init(gen, cfg.d_model, cfg.d_ff)
        params = {"ln1": ln1[0], "attn": at[0], "ln2": ln2[0], "mlp": mlp[0]}
        specs = {"ln1": ln1[1], "attn": at[1], "ln2": ln2[1], "mlp": mlp[1]}
        return params, specs

    def apply(p, x, state, ctx: Ctx):
        h = _norm(cfg, p["ln1"], x)
        if use_mla:
            h, new_state = mla.apply(p["attn"], h, state, ctx, cfg=cfg)
        else:
            h, new_state = attention.apply(
                p["attn"], h, state, ctx, cfg=cfg, causal=causal,
                window=window, rope_theta=rope_theta)
        x = x + h
        h2 = _norm(cfg, p["ln2"], x)
        if use_moe:
            f, aux = moe.apply(p["mlp"], h2, ctx, cfg=cfg)
        else:
            f, aux = ffn.apply(p["mlp"], h2, ctx, act=cfg.act), 0.0
        return x + f, new_state, aux

    def state_spec(batch, cache_len):
        if use_mla:
            return mla.state_spec(cfg, batch, cache_len)
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


def mlstm_block(cfg: ModelConfig, name: str) -> BlockDef:
    """Pre-norm mLSTM mixer block with a residual."""

    def init(gen):
        ln = norms.init(gen, cfg.d_model)
        mx = xlstm.mlstm_init(gen, cfg)
        return {"ln": ln[0], "mix": mx[0]}, {"ln": ln[1], "mix": mx[1]}

    def apply(p, x, state, ctx: Ctx):
        h, new_state = xlstm.mlstm_apply(p["mix"], _norm(cfg, p["ln"], x),
                                         state, ctx, cfg=cfg)
        return x + h, new_state, 0.0

    return BlockDef(name=name, init=init, apply=apply,
                    state_spec=lambda b, c: xlstm.mlstm_state_spec(cfg, b, c))


def slstm_block(cfg: ModelConfig, name: str) -> BlockDef:
    """sLSTM block with a residual (the layer norms its own input)."""

    def apply(p, x, state, ctx: Ctx):
        h, new_state = xlstm.slstm_apply(p, x, state, ctx, cfg=cfg)
        return x + h, new_state, 0.0

    return BlockDef(name=name, init=lambda gen: xlstm.slstm_init(gen, cfg),
                    apply=apply,
                    state_spec=lambda b, c: xlstm.slstm_state_spec(cfg, b, c))


LATER = "is ported by ROADMAP queue 1 item 12 (the other model families)"


def build_plan(cfg: ModelConfig) -> StackPlan:
    """Backbone (decoder) plan of every family but whisper's and
    llama-3.2-vision's."""
    L = cfg.n_layers
    if cfg.family == "ssm":  # xlstm: alternate mLSTM / sLSTM
        assert L % 2 == 0
        return StackPlan(segments=(
            Segment(pattern=(mlstm_block(cfg, "mlstm"),
                             slstm_block(cfg, "slstm")),
                    n_groups=L // 2),))
    if cfg.family == "hybrid":  # zamba2: mamba + shared attn every k
        k = cfg.shared_attn_every
        shared = attn_ffn_block(cfg, "shared_attn", use_extra=True)
        n_groups, tail = divmod(L, k)
        pattern = tuple(mamba_block(cfg, f"mamba{i}") for i in range(k)) \
            + (shared,)
        segs = [Segment(pattern=pattern, n_groups=n_groups)]
        if tail:
            segs.append(Segment(
                pattern=tuple(mamba_block(cfg, f"tail_mamba{i}")
                              for i in range(tail)), n_groups=1))
        return StackPlan(segments=tuple(segs), extra_blocks=(shared,))
    if cfg.moe is not None:  # deepseek: dense layers, then MoE layers
        use_mla = cfg.mla is not None
        nd = cfg.moe.n_dense_layers
        segs = []
        if nd:
            segs.append(Segment(
                pattern=(attn_ffn_block(cfg, "dense", use_mla=use_mla),),
                n_groups=nd))
        segs.append(Segment(
            pattern=(attn_ffn_block(cfg, "moe", use_moe=True,
                                    use_mla=use_mla),),
            n_groups=L - nd))
        return StackPlan(segments=tuple(segs))
    for cond, what in ((cfg.cross_attn_every, "llama-3.2-vision's "
                        "cross-attention layers"),
                       (cfg.encdec, "whisper's encoder-decoder")):
        if cond:
            raise NotImplementedError(f"{what} {LATER}")
    if cfg.global_every:  # gemma3: local:global interleave
        k = cfg.global_every
        theta_local = cfg.rope_theta_local or cfg.rope_theta

        def local(name):
            return attn_ffn_block(cfg, name, window=cfg.sliding_window,
                                  rope_theta=theta_local)

        pattern = tuple(local(f"local{i}") for i in range(k - 1)) \
            + (attn_ffn_block(cfg, "global"),)
        n_groups, tail = divmod(L, k)
        segs = [Segment(pattern=pattern, n_groups=n_groups)]
        if tail:
            segs.append(Segment(
                pattern=tuple(local(f"tail_local{i}") for i in range(tail)),
                n_groups=1))
        return StackPlan(segments=tuple(segs))
    # plain dense decoder (qwen2 / qwen1.5-110b / gemma-7b)
    return StackPlan(segments=(
        Segment(pattern=(attn_ffn_block(cfg, "layer",
                                        window=cfg.sliding_window),),
                n_groups=L),))


def build_encoder_plan(cfg: ModelConfig) -> Optional[StackPlan]:
    if not cfg.encdec:
        return None
    raise NotImplementedError(f"whisper's encoder-decoder {LATER}")
