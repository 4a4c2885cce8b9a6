"""GQA self / cross attention sublayer, train, prefill and decode phases
(port of ``repro.models.layers.attention``).

State protocol (threaded by the layer stack):
  - train:    state None -> None
  - prefill:  state None -> {"k": [B,Smax,Hkv,Dh], "v": ...} (bf16 caches
              padded to ``ctx.cache_len``)
  - decode:   caches in -> the same caches with the new token's k/v
              written at ``ctx.cur_index`` *in place* (the JAX package
              returns updated copies; the port's caller keeps using the
              tensors it passed).  A write at an index past the cache
              is dropped, as JAX's scatter drops it.
Cross-attention (whisper's decoder over ``ctx.enc_memory``, the vision
layers over ``ctx.image_embeds``) projects the source k/v once at
prefill, keeps them as its state (bf16, the source's length) and reads
them unchanged at every decode step.
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
from repro_torch.models.layers.spmd import (flatten_last, mm, pad_seq,
                                           unflatten_last)


def init(gen, cfg: ModelConfig, *, is_cross: bool = False):
    D = cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if is_cross:
        Hkv = H  # cross layers use full-head kv in the assigned archs
    dev = gen.device
    pairs = {
        "wq": iu.dense(gen, (D, H, Dh), ("fsdp", "tp", None)),
        "wk": iu.dense(gen, (D, Hkv, Dh), ("fsdp", "tp", None)),
        "wv": iu.dense(gen, (D, Hkv, Dh), ("fsdp", "tp", None)),
        "wo": iu.dense(gen, (H, Dh, D), ("tp", None, "fsdp"),
                       scale=1.0 / (H * Dh) ** 0.5),
    }
    if cfg.qkv_bias and not is_cross:
        pairs["bq"] = iu.zeros((H, Dh), ("tp", None), device=dev)
        pairs["bk"] = iu.zeros((Hkv, Dh), ("tp", None), device=dev)
        pairs["bv"] = iu.zeros((Hkv, Dh), ("tp", None), device=dev)
    return iu.split_tree(pairs)


def state_spec(cfg: ModelConfig, batch: int, cache_len: int,
               *, is_cross: bool = False, source_len: int = 0):
    """Pytree of (shape, dtype, logical spec) for the decode-time cache: a
    cross layer's holds ``source_len`` rows of full-head k/v."""
    Hkv = cfg.n_heads if is_cross else cfg.n_kv_heads
    slen = source_len if is_cross else cache_len
    sh = (batch, slen, Hkv, cfg.resolved_head_dim)
    spec = ("act_batch", "kv_seq", "kv_heads", None)
    return {"k": (sh, torch.bfloat16, spec), "v": (sh, torch.bfloat16, spec)}


def _proj(x, w, cd):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    D, H, K = w.shape
    return unflatten_last(mm(x.to(cd), w.to(cd).reshape(D, H * K)), H, K)


def _proj_qkv(p, x, kv_src, cd):
    q = _proj(x, p["wq"], cd)
    k = _proj(kv_src, p["wk"], cd)
    v = _proj(kv_src, p["wv"], cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _write_caches(caches, news, idx):
    """Write each new [B,1,...] into its cache [B,S,...] (one S for all)
    at per-request position idx [B] (>= 0), in place; returns the caches.
    A write at idx >= S is dropped, as JAX's scatter drops it (a serving
    engine decodes idle slots too, and their index runs on past the
    cache): the index is clamped and the row already there written back,
    with no host sync.  The rows are worked out once for all the caches.
    DTensor caches are written shard by shard (:func:`_write_shards`)."""
    if hasattr(caches[0], "device_mesh"):
        return _write_shards(caches, news, idx)
    S = caches[0].shape[1]
    b = torch.arange(caches[0].shape[0], device=caches[0].device)
    idx = idx.to(torch.int64)
    row = idx.clamp(0, S - 1)
    past = idx >= S
    for cache, new in zip(caches, news):
        new = new[:, 0].to(cache.dtype)
        keep = past.view((-1,) + (1,) * (new.ndim - 1))
        cache[b, row] = torch.where(keep, cache[b, row], new)
    return caches


def _write_shards(caches, news, idx):
    """:func:`_write_caches` on DTensor caches: each rank writes its own
    shard in place -- the requests of its batch rows, at the positions of
    its sequence rows (a write outside them is another rank's, and is
    dropped here as one past the cache is)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    c0 = caches[0]
    mesh = c0.device_mesh
    shape, off = compute_local_shape_and_global_offset(
        c0.shape, mesh, c0.placements)
    idx = idx.full_tensor() if hasattr(idx, "full_tensor") else idx
    idx = idx.to(torch.int64)[off[0]:off[0] + shape[0]] - off[1]
    S = shape[1]
    b = torch.arange(shape[0], device=idx.device)
    row = idx.clamp(0, S - 1)
    past = (idx >= S) | (idx < 0)
    # the new rows in the caches' placements, their one position whole
    pl = tuple(Replicate() if p.is_shard() and p.dim == 1 else p
               for p in c0.placements)
    for cache, new in zip(caches, news):
        if hasattr(new, "device_mesh"):
            new = new.redistribute(mesh, pl).to_local()
        new = new[:, 0].to(cache.dtype)
        local = cache.to_local()
        keep = past.view((-1,) + (1,) * (new.ndim - 1))
        local[b, row] = torch.where(keep, local[b, row], new)
    return caches


def _out(y, p, cd):
    """einsum("bshk,hkd->bsd") as one matmul over the flattened heads."""
    B, S, H, Dv = y.shape
    wo = p["wo"].to(cd)
    return mm(flatten_last(y.to(cd)), wo.reshape(H * Dv, wo.shape[-1]))


def apply(p, x, state, ctx: Ctx, *, cfg: ModelConfig, causal: bool = True,
          window: int = 0, is_cross: bool = False, cross_source: str = "",
          rope_theta: Optional[float] = None):
    cd = ctx.cdtype
    theta = rope_theta if rope_theta is not None else cfg.rope_theta

    if is_cross:
        if ctx.is_decode and state is not None:
            q = _proj(x, p["wq"], cd)
            k, v = state["k"], state["v"]
            lengths = torch.full((x.shape[0],), k.shape[1], dtype=torch.int32,
                                 device=x.device)
            y = dec_ops.decode_attend(q, k, v, lengths)
            new_state = state
        else:
            src = ctx.image_embeds if cross_source == "image" \
                else ctx.enc_memory
            q, k, v = _proj_qkv(p, x, src, cd)
            y = attn_ops.mha(q, k, v, causal=False)
            new_state = {"k": k.to(torch.bfloat16),
                         "v": v.to(torch.bfloat16)}
        out = ctx.constrain(_out(y, p, cd), ("act_batch", "act_seq", None))
        return out, new_state

    q, k, v = _proj_qkv(p, x, x, cd)
    q = ctx.constrain(q, ("act_batch", None, "heads", None))
    k = ctx.constrain(k, ("act_batch", None, "kv_heads", None))
    positions = ctx.positions
    q = rope_mod.apply_rope(q, positions, theta=theta)
    k = rope_mod.apply_rope(k, positions, theta=theta)

    if ctx.phase == "decode":
        kc, vc = _write_caches((state["k"], state["v"]), (k, v),
                               ctx.cur_index)
        lengths = (ctx.cur_index + 1).to(torch.int32)
        y = dec_ops.decode_attend(q, kc, vc, lengths, window=window)
        new_state = {"k": kc, "v": vc}
    else:
        y = attn_ops.mha(q, k, v, causal=causal, window=window)
        if ctx.phase == "prefill":
            pad = ctx.cache_len - k.shape[1]
            padded = lambda t: pad_seq(t, 0, pad).to(torch.bfloat16)
            new_state = {"k": padded(k), "v": padded(v)}
        else:
            new_state = None
    out = ctx.constrain(_out(y, p, cd), ("act_batch", "act_seq", None))
    return out, new_state
