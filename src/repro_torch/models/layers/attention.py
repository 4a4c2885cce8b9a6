"""GQA self-attention sublayer, prefill and decode phases (port of
``repro.models.layers.attention``).

State protocol (threaded by the layer stack):
  - train:    state None -> None
  - prefill:  state None -> {"k": [B,Smax,Hkv,Dh], "v": ...} (bf16 caches
              padded to ``ctx.cache_len``)
  - decode:   caches in -> the same caches with the new token's k/v
              written at ``ctx.cur_index`` *in place* (the JAX package
              returns updated copies; the port's caller keeps using the
              tensors it passed).

Cross-attention (whisper's decoder, the vision layers) waits for the
slice that ports those families.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.models import init_utils as iu
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import rope as rope_mod

CROSS_TODO = ("cross-attention (whisper's decoder, llama-3.2-vision's "
              "image layers) is ported with those families by ROADMAP "
              "queue 1 item 12")


def init(gen, cfg: ModelConfig, *, is_cross: bool = False):
    if is_cross:
        raise NotImplementedError(CROSS_TODO)
    D = cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dev = gen.device
    pairs = {
        "wq": iu.dense(gen, (D, H, Dh), ("fsdp", "tp", None)),
        "wk": iu.dense(gen, (D, Hkv, Dh), ("fsdp", "tp", None)),
        "wv": iu.dense(gen, (D, Hkv, Dh), ("fsdp", "tp", None)),
        "wo": iu.dense(gen, (H, Dh, D), ("tp", None, "fsdp"),
                       scale=1.0 / (H * Dh) ** 0.5),
    }
    if cfg.qkv_bias:
        pairs["bq"] = iu.zeros((H, Dh), ("tp", None), device=dev)
        pairs["bk"] = iu.zeros((Hkv, Dh), ("tp", None), device=dev)
        pairs["bv"] = iu.zeros((Hkv, Dh), ("tp", None), device=dev)
    return iu.split_tree(pairs)


def state_spec(cfg: ModelConfig, batch: int, cache_len: int,
               *, is_cross: bool = False):
    """Pytree of (shape, dtype, logical spec) for the decode-time cache."""
    if is_cross:
        raise NotImplementedError(CROSS_TODO)
    sh = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    spec = ("act_batch", "kv_seq", "kv_heads", None)
    return {"k": (sh, torch.bfloat16, spec), "v": (sh, torch.bfloat16, spec)}


def _proj(x, w, cd):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    D, H, K = w.shape
    return (x.to(cd) @ w.to(cd).reshape(D, H * K)).unflatten(-1, (H, K))


def _proj_qkv(p, x, cd):
    q = _proj(x, p["wq"], cd)
    k = _proj(x, p["wk"], cd)
    v = _proj(x, p["wv"], cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _write_cache(cache, new, idx):
    """Write new [B,1,H,D] at per-request position idx [B], in place.
    Every idx must lie below the cache length (JAX's scatter drops
    out-of-range writes; a CUDA index_put_ would fault)."""
    b = torch.arange(cache.shape[0], device=cache.device)
    cache[b, idx.to(torch.int64)] = new[:, 0].to(cache.dtype)
    return cache


def apply(p, x, state, ctx: Ctx, *, cfg: ModelConfig, causal: bool = True,
          window: int = 0, is_cross: bool = False,
          rope_theta: Optional[float] = None):
    if is_cross:
        raise NotImplementedError(CROSS_TODO)
    cd = ctx.cdtype
    theta = rope_theta if rope_theta is not None else cfg.rope_theta

    q, k, v = _proj_qkv(p, x, cd)
    positions = ctx.positions
    q = rope_mod.apply_rope(q, positions, theta=theta)
    k = rope_mod.apply_rope(k, positions, theta=theta)

    if ctx.phase == "decode":
        kc = _write_cache(state["k"], k, ctx.cur_index)
        vc = _write_cache(state["v"], v, ctx.cur_index)
        lengths = (ctx.cur_index + 1).to(torch.int32)
        y = dec_ops.decode_attend(q, kc, vc, lengths, window=window)
        new_state = {"k": kc, "v": vc}
    else:
        y = attn_ops.mha(q, k, v, causal=causal, window=window)
        if ctx.phase == "prefill":
            pad = ctx.cache_len - k.shape[1]
            padded = lambda t: torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, pad)).to(torch.bfloat16)
            new_state = {"k": padded(k), "v": padded(v)}
        else:
            new_state = None

    B, S, H, Dv = y.shape
    wo = p["wo"].to(cd)
    out = y.to(cd).reshape(B, S, H * Dv) @ wo.reshape(H * Dv, wo.shape[-1])
    return out, new_state
