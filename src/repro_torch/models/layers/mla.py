"""Multi-head Latent Attention, DeepSeek-V2 (port of
``repro.models.layers.mla``).

Caches the compressed latent ``c_kv`` and the shared rope key (bf16,
``kv_lora_rank + rope_head_dim`` values a token against ``2 * H * Dh``).
Prefill decompresses to per-head K (nope || rope, Dh = nope + rope) and V
(Dv) and runs ``attn_ops.mha``; decode writes the new token's latents
into the caches in place (as ``attention.py`` does its k/v), decompresses
the whole cache and runs ``dec_ops.decode_attend``.  Dh != Dv on both
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.models import init_utils as iu
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import norms
from repro_torch.models.layers import rope as rope_mod
from repro_torch.models.layers.attention import _proj, _write_caches
from repro_torch.models.layers.spmd import flatten_last, mm, pad_seq


def init(gen, cfg: ModelConfig):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    q_in = m.q_lora_rank or D
    pairs = {
        "w_dkv": iu.dense(gen, (D, m.kv_lora_rank + m.rope_head_dim),
                          ("fsdp", None)),
        "w_uk": iu.dense(gen, (m.kv_lora_rank, H, m.nope_head_dim),
                         (None, "tp", None)),
        "w_uv": iu.dense(gen, (m.kv_lora_rank, H, m.v_head_dim),
                         (None, "tp", None)),
        "wq": iu.dense(gen, (q_in, H, m.nope_head_dim + m.rope_head_dim),
                       ("fsdp", "tp", None)),
        "wo": iu.dense(gen, (H, m.v_head_dim, D), ("tp", None, "fsdp"),
                       scale=1.0 / (H * m.v_head_dim) ** 0.5),
    }
    if m.q_lora_rank:
        pairs["w_dq"] = iu.dense(gen, (D, m.q_lora_rank), ("fsdp", None))
    params, specs = iu.split_tree(pairs)
    np_, ns = norms.init(gen, m.kv_lora_rank)
    params["kv_norm"], specs["kv_norm"] = np_, ns
    return params, specs


def state_spec(cfg: ModelConfig, batch: int, cache_len: int):
    m = cfg.mla
    return {
        "c_kv": ((batch, cache_len, m.kv_lora_rank), torch.bfloat16,
                 ("act_batch", "kv_seq", None)),
        "k_rope": ((batch, cache_len, m.rope_head_dim), torch.bfloat16,
                   ("act_batch", "kv_seq", None)),
    }


def _latent(p, x, ctx: Ctx, cd):
    """x -> the normed latent [B,S,R] and the roped shared key [B,S,r]
    (the norm at its default eps, the rope at its default theta)."""
    dkv = mm(x.to(cd), p["w_dkv"].to(cd))
    lora = p["w_uk"].shape[0]
    # the norm kernel takes contiguous rows
    c_kv = norms.apply(p["kv_norm"], dkv[..., :lora].contiguous())
    k_rope = rope_mod.apply_rope(dkv[..., lora:], ctx.positions)
    return c_kv, k_rope


def _queries(p, x, ctx: Ctx, cd, rope_dim: int):
    q_in = x.to(cd)
    if "w_dq" in p:
        q_in = mm(q_in, p["w_dq"].to(cd))
    q = _proj(q_in, p["wq"], cd)
    q_nope, q_rope = q[..., :-rope_dim], q[..., -rope_dim:]
    q_rope = rope_mod.apply_rope(q_rope, ctx.positions)
    return torch.cat([q_nope, q_rope], dim=-1)


def _decompress(p, c_kv, k_rope, cd):
    """Latents -> per-head K (nope || rope) [B,S,H,Dh] and V [B,S,H,Dv]."""
    k_nope = _proj(c_kv, p["w_uk"], cd)
    v = _proj(c_kv, p["w_uv"], cd)
    k_rope_h = k_rope[:, :, None, :].to(cd).expand(
        k_nope.shape[:3] + (k_rope.shape[-1],))
    return torch.cat([k_nope, k_rope_h], dim=-1), v


def apply(p, x, state, ctx: Ctx, *, cfg: ModelConfig):
    m = cfg.mla
    cd = ctx.cdtype
    q = _queries(p, x, ctx, cd, m.rope_head_dim)
    c_kv, k_rope = _latent(p, x, ctx, cd)

    if ctx.phase == "decode":
        c_cache, kr_cache = _write_caches(
            (state["c_kv"], state["k_rope"]), (c_kv, k_rope), ctx.cur_index)
        k, v = _decompress(p, c_cache, kr_cache, cd)
        lengths = (ctx.cur_index + 1).to(torch.int32)
        y = dec_ops.decode_attend(q, k, v, lengths)
        new_state = {"c_kv": c_cache, "k_rope": kr_cache}
    else:
        k, v = _decompress(p, c_kv, k_rope, cd)
        y = attn_ops.mha(q, k, v, causal=True)
        if ctx.phase == "prefill":
            pad = ctx.cache_len - c_kv.shape[1]
            padded = lambda t: pad_seq(t, 0, pad).to(torch.bfloat16)
            new_state = {"c_kv": padded(c_kv), "k_rope": padded(k_rope)}
        else:
            new_state = None

    B, S, H, Dv = y.shape
    wo = p["wo"].to(cd)
    out = mm(flatten_last(y.to(cd)), wo.reshape(H * Dv, wo.shape[-1]))
    return ctx.constrain(out, ("act_batch", "act_seq", None)), new_state
