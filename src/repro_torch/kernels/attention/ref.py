"""Plain PyTorch version of (flash) attention: the CPU path and the
``flash_attention`` kernel's oracle (port of ``repro/kernels/attention/
ref.py::mha``).

f32 throughout, chunked over query blocks so the S x S score matrix is
never whole.  Supports GQA (kv heads repeated), causal masking with a
query offset, sliding windows, different K/V head dims, and the
bidirectional (encoder) mode.  A row every key of which is masked gets
uniform weights, as in the JAX oracle (the kernel gives it 0; no row of
the model's masks is ever fully masked).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(x, rep: int):
    if rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, rep, d).reshape(
        b, s, h * rep, d)


def _block_attend(qc, k, v, rows, cols, *, causal, window, scale):
    """One query block.  qc: [B,C,H,Dh]; k, v: [B,Skv,H,D*] (f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qc.to(torch.float32), k) * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask &= cols[None, :] <= rows[:, None]
    if window:
        mask &= cols[None, :] > rows[:, None] - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def mha(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
        chunk: int = 512):
    """q: [B,Sq,H,Dh]; k: [B,Skv,Hkv,Dh]; v: [B,Skv,Hkv,Dv] ->
    [B,Sq,H,Dv] in q's dtype.

    ``q_offset``: absolute position of q row 0 minus kv row 0 (chunked
    prefill); full self-attention uses 0 with Sq == Skv."""
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    rep = H // Hkv
    k = _repeat_kv(k, rep).to(torch.float32)
    v = _repeat_kv(v, rep).to(torch.float32)
    scale = Dh ** -0.5
    cols = torch.arange(Skv, device=q.device)
    outs = []
    for c0 in range(0, Sq, chunk):
        qc = q[:, c0:c0 + chunk]
        rows = torch.arange(c0, c0 + qc.shape[1], device=q.device) + q_offset
        outs.append(_block_attend(qc, k, v, rows, cols, causal=causal,
                                  window=window, scale=scale))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.to(q.dtype)


def mha_bwd(q, k, v, do, *, causal: bool = True, window: int = 0,
            q_offset: int = 0, chunk: int = 512):
    """The plain backward, the ``flash_attention_bwd`` kernel's oracle:
    autograd of :func:`mha`.  Returns ``(dq, dk, dv)`` in q's dtype."""
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = mha(qg, kg, vg, causal=causal, window=window, q_offset=q_offset,
                chunk=chunk)
        return torch.autograd.grad(o, (qg, kg, vg), do)
