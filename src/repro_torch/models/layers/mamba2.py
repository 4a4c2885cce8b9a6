"""Mamba-2 (SSD) mixer block (port of ``repro.models.layers.mamba2``).

in_proj -> [z | xBC | dt]; causal depthwise conv over xBC; SSD linear
recurrence via the shared chunked primitive (``kernels/ssd``: the
``ssd_scan`` kernel at prefill on the card, ``ssd_step`` in decode);
gated RMSNorm; out_proj.  Decode threads (conv_state, ssd_state), as the
JAX package does; the port writes both into the caller's state views in
place (``models/stack.py``'s decode contract) instead of returning
copies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import init_utils as iu
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import norms
from repro_torch.models.layers.spmd import mm, pad_seq


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_conv_ch = d_inner + 2 * s.state_dim  # conv runs over [x|B|C]
    return s, d_inner, n_heads, d_conv_ch


def init(gen, cfg: ModelConfig):
    s, d_inner, H, conv_ch = _dims(cfg)
    D = cfg.d_model
    dev = gen.device
    proj_out = d_inner + conv_ch + H  # z | xBC | dt
    params, specs = iu.split_tree({
        "in_proj": iu.dense(gen, (D, proj_out), ("fsdp", "tp")),
        "conv_w": iu.dense(gen, (s.d_conv, conv_ch), (None, "tp"),
                           scale=1.0 / s.d_conv ** 0.5),
        "conv_b": iu.zeros((conv_ch,), ("tp",), device=dev),
        "dt_bias": iu.zeros((H,), ("tp",), device=dev),
        "a_log": iu.ones((H,), ("tp",), device=dev),
        "d_skip": iu.ones((H,), ("tp",), device=dev),
        "out_proj": iu.dense(gen, (d_inner, D), ("tp", "fsdp"),
                             scale=1.0 / d_inner ** 0.5),
    })
    np_, ns = norms.init(gen, d_inner)
    params["norm"], specs["norm"] = np_, ns
    return params, specs


def state_spec(cfg: ModelConfig, batch: int, cache_len: int):
    s, d_inner, H, conv_ch = _dims(cfg)
    del cache_len  # SSM state is O(1) in sequence length
    return {
        "conv": ((batch, s.d_conv - 1, conv_ch), torch.float32,
                 ("act_batch", None, "tp")),
        "ssd": ((batch, H, s.state_dim, s.head_dim), torch.float32,
                ("act_batch", "heads", None, None)),
    }


def _conv_full(xbc, w, b):
    """Causal depthwise conv, width W, via shifted adds (in xbc's dtype,
    in the JAX package's order).  xbc: [B,S,C]."""
    W = w.shape[0]
    S = xbc.shape[1]
    out = xbc * w[W - 1]
    for i in range(1, W):
        shifted = pad_seq(xbc, i, 0)[:, :S]
        out = out + shifted * w[W - 1 - i]
    return F.silu(out + b)


def _split(cfg, zxd, d_inner, conv_ch):
    z = zxd[..., :d_inner]
    xbc = zxd[..., d_inner:d_inner + conv_ch]
    dt_raw = zxd[..., d_inner + conv_ch:]
    return z, xbc, dt_raw


def apply(p, x, state, ctx: Ctx, *, cfg: ModelConfig):
    s, d_inner, H, conv_ch = _dims(cfg)
    cd = ctx.cdtype
    f32 = torch.float32
    B, S, _ = x.shape
    N, P = s.state_dim, s.head_dim

    zxd = mm(x.to(cd), p["in_proj"].to(cd))
    z, xbc, dt_raw = _split(cfg, zxd, d_inner, conv_ch)
    w = p["conv_w"].to(cd)
    b = p["conv_b"].to(cd)

    if ctx.is_decode:
        # conv over [conv_state | new token]
        hist = torch.cat([state["conv"].to(cd), xbc], dim=1)
        xbc_c = F.silu(torch.einsum("bwc,wc->bc", hist, w) + b)[:, None]
        new_conv = hist[:, 1:]
    else:
        xbc_c = _conv_full(xbc, w, b)
        new_conv = xbc[:, S - (s.d_conv - 1):, :].to(f32) \
            if ctx.phase == "prefill" else None

    xs = xbc_c[..., :d_inner].reshape(B, -1, H, P)
    Bmat = xbc_c[..., d_inner:d_inner + N]                    # [B,S,N]
    Cmat = xbc_c[..., d_inner + N:]                           # [B,S,N]
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))    # [B,S,H]
    a = -torch.exp(p["a_log"].to(f32))                        # [H] < 0
    log_a = dt * a                                            # [B,S,H]

    # every head reads the same B and C: head-broadcast views, no copies
    q = Cmat[:, :, None, :].expand(B, Cmat.shape[1], H, N)
    k = Bmat[:, :, None, :].expand(B, Bmat.shape[1], H, N)
    v = xs * dt[..., None].to(cd)

    if ctx.is_decode:
        ssd_state, y = ssd_ops.ssd_step(
            state["ssd"], q[:, 0], k[:, 0], v[:, 0], log_a[:, 0])
        y = y[:, None]
        # the decode contract: write into the caller's state views
        state["conv"].copy_(new_conv)
        state["ssd"].copy_(ssd_state)
        new_state = state
    else:
        # the scan's layout on a mesh: its heads over "model" where they
        # divide it (the four inputs alike, so each rank scans its heads),
        # else the residual stream's sequence split (the prefill and train
        # rules' act_seq): the carried-state route across ranks
        heads = ("act_batch", "act_seq", "heads")
        q, k, v = (ctx.constrain(t, heads + (None,)) for t in (q, k, v))
        log_a = ctx.constrain(log_a, heads)
        y, final = ssd_ops.ssd(q, k, v, log_a, chunk=s.chunk)
        new_state = ({"conv": new_conv, "ssd": final}
                     if ctx.phase == "prefill" else None)

    y = y + p["d_skip"].to(cd)[None, None, :, None] * xs
    y = y.reshape(B, -1, d_inner)
    y = norms.apply(p["norm"], y * F.silu(z), eps=cfg.norm_eps)
    out = mm(y.to(cd), p["out_proj"].to(cd))
    return ctx.constrain(out, ("act_batch", "act_seq", None)), new_state
