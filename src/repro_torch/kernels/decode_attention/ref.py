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


def decode_attend(q, k_cache, v_cache, lengths, *, window: int = 0,
                  partial: bool = False, seq_offset: int = 0,
                  seq_total: int = None):
    """q: [B,Sq,H,Dh] (Sq small); caches: [B,S,Hkv,D*]; lengths: [B], the
    number of valid cache rows (the new token's k/v already written at
    lengths - 1; clamped to [0, S]).  Returns [B,Sq,H,Dv] in q's dtype.

    With ``partial`` (the kernel's keywords), the local half of the route
    over a cache whose sequence is split across ranks: the caches are rows
    ``[seq_offset, seq_offset + S)`` of a ``seq_total``-row cache (the mask
    in global positions, ``lengths`` clamped to ``seq_total``), and it
    returns ``(o [B,Sq,H,Dv], lse [B,Sq,H])`` in f32: the output over the
    slice and each row's log-sum-exp of its scores; a row with no visible
    key on the slice gives ``o = 0``, ``lse = -inf``, as the kernel
    does."""
    B, Sq, H, Dh = q.shape
    _, S, Hkv, Dv = v_cache.shape
    total = S if seq_total is None else seq_total
    rep = H // Hkv
    scale = Dh ** -0.5
    f32 = torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32),
                     _rep(k_cache, rep).to(f32)) * scale
    cols = seq_offset + torch.arange(S, device=q.device)[None, None, None, :]
    # lengths past the cache are clamped to it, as the kernel clamps them
    # (an idle serving slot's cur_index + 1 runs past the cache; the JAX
    # oracle differs there only under a window, in rows nothing reads)
    lens = lengths.to(cols.dtype).clamp(0, total)[:, None, None, None]
    valid = cols < lens
    if window:
        valid &= cols >= lens - window
    if partial:
        s = torch.where(valid, s, -torch.inf)
        m = s.amax(-1, keepdim=True)
        seen = torch.isfinite(m)
        e = torch.exp(s - torch.where(seen, m, 0.0))
        # 1 where nothing is seen: no 0 reaches the log or its gradient
        den = torch.where(seen, e.sum(-1, keepdim=True), 1.0)
        p = e / den
    else:
        p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    # the probabilities in the cache's dtype before the PV product
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype).to(f32),
                       _rep(v_cache, rep).to(f32))
    if not partial:
        return out.to(q.dtype)
    lse = torch.where(seen, m + torch.log(den), -torch.inf)[..., 0]
    return out, lse.permute(0, 2, 1)
