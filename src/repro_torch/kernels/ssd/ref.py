"""Plain PyTorch version of the chunked linear recurrence (Mamba-2 SSD /
mLSTM): the CPU path and the ``ssd_scan`` kernel's oracle (port of
``repro/kernels/ssd/ref.py``).

Recurrent definition (per batch b, head h):
    S_t = exp(log_a_t) * S_{t-1} + k_t^T v_t        # state [N, P]
    y_t = q_t . S_t                                  # contract N

The chunked algorithm processes L-step blocks with intra-chunk quadratic
attention and an inter-chunk sequential state pass, with the carried state
in f32, as the JAX oracle does (a Python loop over chunks in place of
``lax.scan``).
"""
from __future__ import annotations

import torch


def ssd_step(state, q, k, v, log_a):
    """Single decode step.  state: [B,H,N,P]; q,k: [B,H,N]; v: [B,H,P];
    log_a: [B,H].  Returns (new_state, y [B,H,P])."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    new_state = a * state.to(f32) + (
        k.to(f32)[..., :, None] * v.to(f32)[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", q.to(f32), new_state)
    return new_state.to(state.dtype), y.to(v.dtype)


def ssd(q, k, v, log_a, *, chunk: int = 256, initial_state=None):
    """q,k: [B,S,H,N]; v: [B,S,H,P]; log_a: [B,S,H] (<= 0).

    Returns (y [B,S,H,P], final_state [B,H,N,P])."""
    f32 = torch.float32
    B, S, H, N = q.shape
    P = v.shape[-1]
    pad = (-S) % chunk
    if pad:
        zp = lambda x: torch.nn.functional.pad(
            x, (0, 0) * (x.ndim - 2) + (0, pad))
        q, k, v, log_a = zp(q), zp(k), zp(v), zp(log_a)
    L = chunk
    nc = (S + pad) // L
    state = (torch.zeros((B, H, N, P), dtype=f32, device=q.device)
             if initial_state is None else initial_state.to(f32))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        qb, kb, vb = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        cum = torch.cumsum(log_a[:, sl].to(f32), dim=1)        # [B,L,H]
        # --- intra-chunk (quadratic within L) ---
        scores = torch.einsum("blhn,bmhn->bhlm", qb, kb)
        ct = cum.transpose(1, 2)                               # [B,H,L]
        dmat = ct[:, :, :, None] - ct[:, :, None, :]           # cum_l - cum_m
        decay = torch.where(tri, torch.exp(dmat), 0.0)
        y_intra = torch.einsum("bhlm,bmhp->blhp", scores * decay, vb)
        # --- inter-chunk (carried state) ---
        y_inter = torch.einsum("blhn,bhnp->blhp",
                               qb * torch.exp(cum)[..., None], state)
        # --- state update ---
        end_decay = torch.exp(cum[:, -1:, :] - cum)            # [B,L,H]
        s_chunk = torch.einsum("blhn,blhp->bhnp",
                               kb * end_decay[..., None], vb)
        state = torch.exp(cum[:, -1, :])[..., None, None] * state + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(v.dtype), state
