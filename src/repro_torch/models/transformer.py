"""Block builders and per-architecture StackPlans (port of
``repro.models.transformer``).

Ported: the dense decoders (qwen2 / qwen1.5-110b / gemma-7b: one
attention + gated-FFN block repeated; gemma3: windowed local layers with
their own rope theta, every ``global_every``-th layer global, then a tail
of locals), the hybrid family (zamba2: groups of Mamba-2 blocks, each
closed by one weight-shared attention block, then a tail of Mamba-2
blocks), the xLSTM family (alternating mLSTM / sLSTM blocks), the
DeepSeek family (leading dense layers, then MoE layers; MLA attention
where the config has it), llama-3.2-vision (groups of self-attention
blocks, each closed by a cross-attention block over the image
embeddings) and whisper (a bidirectional encoder plan, and decoder
blocks of self-attention, cross-attention over the encoder output and a
gated FFN).
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
                   use_moe: bool = False, cross: bool = False,
                   cross_source: str = "", use_extra: bool = False,
                   use_mla: bool = False, source_len: int = 0) -> BlockDef:
    """Pre-norm attention (self, MLA, or with ``cross`` cross-attention
    over ``cross_source``'s memory of ``source_len`` rows) + gated FFN
    (or MoE) block; with ``use_extra`` its parameters are the plan's
    shared (unstacked) ones, its state per group."""

    def init(gen):
        ln1 = norms.init(gen, cfg.d_model, scale_offset=cfg.norm_scale_offset)
        at = mla.init(gen, cfg) if use_mla else \
            attention.init(gen, cfg, is_cross=cross)
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
                window=window, is_cross=cross, cross_source=cross_source,
                rope_theta=rope_theta)
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
        slen = source_len or cache_len
        return attention.state_spec(cfg, batch, cache_len, is_cross=cross,
                                    source_len=slen if cross else 0)

    return BlockDef(name=name, init=init, apply=apply, state_spec=state_spec,
                    use_extra=use_extra)


def encdec_decoder_block(cfg: ModelConfig, name: str) -> BlockDef:
    """Whisper decoder layer: causal self-attention, cross-attention over
    the encoder output (``ctx.enc_memory``), gated FFN; state ``{"self",
    "cross"}``, the cross cache sized ``cache_len`` as in the JAX
    package (so a prefill's cross k/v, the prompt bucket's length, fits
    a decode slot only when the bucket is ``cache_len``)."""

    def init(gen):
        parts = {
            "ln1": norms.init(gen, cfg.d_model),
            "self": attention.init(gen, cfg),
            "ln2": norms.init(gen, cfg.d_model),
            "cross": attention.init(gen, cfg, is_cross=True),
            "ln3": norms.init(gen, cfg.d_model),
            "mlp": ffn.init(gen, cfg.d_model, cfg.d_ff),
        }
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items()})

    def apply(p, x, state, ctx: Ctx):
        s_self = state["self"] if state is not None else None
        s_cross = state["cross"] if state is not None else None
        h, ns_self = attention.apply(p["self"], _norm(cfg, p["ln1"], x),
                                     s_self, ctx, cfg=cfg, causal=True)
        x = x + h
        h, ns_cross = attention.apply(p["cross"], _norm(cfg, p["ln2"], x),
                                      s_cross, ctx, cfg=cfg, is_cross=True,
                                      cross_source="memory")
        x = x + h
        x = x + ffn.apply(p["mlp"], _norm(cfg, p["ln3"], x), ctx, act=cfg.act)
        new_state = None
        if ns_self is not None or ns_cross is not None:
            new_state = {"self": ns_self, "cross": ns_cross}
        return x, new_state, 0.0

    def state_spec(batch, cache_len):
        return {
            "self": attention.state_spec(cfg, batch, cache_len),
            "cross": attention.state_spec(cfg, batch, cache_len,
                                          is_cross=True,
                                          source_len=cache_len),
        }

    return BlockDef(name=name, init=init, apply=apply, state_spec=state_spec)


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


def build_plan(cfg: ModelConfig) -> StackPlan:
    """Backbone (decoder) plan for every assigned architecture."""
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
    if cfg.cross_attn_every:  # llama-3.2 vision
        k = cfg.cross_attn_every
        assert L % k == 0
        pattern = tuple(attn_ffn_block(cfg, f"self{i}") for i in range(k - 1))
        pattern += (attn_ffn_block(cfg, "xattn", cross=True,
                                   cross_source="image",
                                   source_len=cfg.n_image_tokens),)
        return StackPlan(segments=(Segment(pattern=pattern,
                                           n_groups=L // k),))
    if cfg.encdec:  # whisper decoder
        return StackPlan(segments=(
            Segment(pattern=(encdec_decoder_block(cfg, "dec"),),
                    n_groups=L),))
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
    """whisper's encoder: bidirectional attention + FFN blocks."""
    if not cfg.encdec:
        return None
    return StackPlan(segments=(
        Segment(pattern=(attn_ffn_block(cfg, "enc", causal=False),),
                n_groups=cfg.n_enc_layers),))
