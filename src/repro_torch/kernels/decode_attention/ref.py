"""Plain PyTorch version of single-token (decode) attention over a KV
cache: the CPU path and the ``decode_attention`` kernel's oracle (port of
``repro/kernels/decode_attention/ref.py::decode_attend``).

As in the JAX oracle, products accumulate in f32 (the operands are
widened, which is exact for bf16) and the probabilities are cast to the
cache's dtype before the PV product.  The kernel keeps them f32, so the
two differ within the bf16 tolerance, as the TPU kernel and the JAX
oracle do.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _rep(x, rep):
    if rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, rep, d).reshape(
        b, s, h * rep, d)


def decode_attend(q, k_cache, v_cache, lengths, *, window: int = 0):
    """q: [B,Sq,H,Dh] (Sq small); caches: [B,S,Hkv,D*]; lengths: [B], the
    number of valid cache rows (the new token's k/v already written at
    lengths - 1; clamped to [0, S]).  Returns [B,Sq,H,Dv] in q's dtype."""
    B, Sq, H, Dh = q.shape
    _, S, Hkv, Dv = v_cache.shape
    rep = H // Hkv
    scale = Dh ** -0.5
    f32 = torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32),
                     _rep(k_cache, rep).to(f32)) * scale
    cols = torch.arange(S, device=q.device)[None, None, None, :]
    # lengths past the cache are clamped to S, as the kernel clamps them
    # (an idle serving slot's cur_index + 1 runs past the cache; the JAX
    # oracle differs there only under a window, in rows nothing reads)
    lens = lengths.to(cols.dtype).clamp(0, S)[:, None, None, None]
    valid = cols < lens
    if window:
        valid &= cols >= lens - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype).to(f32),
                       _rep(v_cache, rep).to(f32))
    return out.to(q.dtype)
