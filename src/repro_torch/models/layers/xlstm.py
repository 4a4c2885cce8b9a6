"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM
(scalar memory, strictly recurrent) (port of
``repro.models.layers.xlstm``).

mLSTM uses the shared SSD primitive (``kernels/ssd``): state C_t = f_t C
+ i_t k v^T with a normalizer row folded in as an extra value channel
(sigmoid input gate, the non-stabilized variant of xLSTM-7B).  Its state
is N x (N + 1) a head (N = d_inner / heads), so P = N + 1 is odd and the
``ssd_scan`` kernel's ``supported()`` refuses it, as the JAX package's
refuses it for its Pallas kernel: the mLSTM takes the plain version in
both packages.  sLSTM keeps the exponential gating and (c, n, m)
stabilizer of the paper and runs as a Python loop over time (the JAX
package's ``lax.scan``; the hidden-to-hidden recurrence is not
associative).  Decode writes every state into the caller's views in
place (``models/stack.py``'s decode contract).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import init_utils as iu
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import norms
from repro_torch.models.layers.attention import _proj
from repro_torch.models.layers.mamba2 import _conv_full
from repro_torch.models.layers.spmd import mm

# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def _mdims(cfg: ModelConfig):
    x = cfg.xlstm
    d_inner = x.mlstm_expand * cfg.d_model
    H = cfg.n_heads
    return x, d_inner, H, d_inner // H


def mlstm_init(gen, cfg: ModelConfig):
    x, d_inner, H, N = _mdims(cfg)
    D = cfg.d_model
    dev = gen.device
    params, specs = iu.split_tree({
        "w_up": iu.dense(gen, (D, 2 * d_inner), ("fsdp", "tp")),
        "conv_w": iu.dense(gen, (x.conv_width, d_inner), (None, "tp"),
                           scale=1.0 / x.conv_width ** 0.5),
        "conv_b": iu.zeros((d_inner,), ("tp",), device=dev),
        "w_q": iu.dense(gen, (d_inner, H, N), ("tp", None, None)),
        "w_k": iu.dense(gen, (d_inner, H, N), ("tp", None, None)),
        "w_v": iu.dense(gen, (d_inner, H, N), ("tp", None, None)),
        "w_gates": iu.dense(gen, (d_inner, 2 * H), ("tp", None),
                            scale=0.02),
        "gate_bias": iu.ones((2 * H,), (None,), device=dev),
        "w_down": iu.dense(gen, (d_inner, D), ("tp", "fsdp"),
                           scale=1.0 / d_inner ** 0.5),
    })
    np_, ns = norms.init(gen, d_inner)
    params["norm"], specs["norm"] = np_, ns
    return params, specs


def mlstm_state_spec(cfg: ModelConfig, batch: int, cache_len: int):
    x, d_inner, H, N = _mdims(cfg)
    del cache_len  # O(1) in sequence length
    return {
        "conv": ((batch, x.conv_width - 1, d_inner), torch.float32,
                 ("act_batch", None, "tp")),
        "mem": ((batch, H, N, N + 1), torch.float32,
                ("act_batch", "heads", None, None)),
    }


def mlstm_apply(p, x, state, ctx: Ctx, *, cfg: ModelConfig):
    xc_cfg, d_inner, H, N = _mdims(cfg)
    cd = ctx.cdtype
    f32 = torch.float32
    B, S, _ = x.shape
    up = mm(x.to(cd), p["w_up"].to(cd))
    xin, z = up[..., :d_inner], up[..., d_inner:]
    w, b = p["conv_w"].to(cd), p["conv_b"].to(cd)

    if ctx.is_decode:
        # conv over [conv_state (f32, cast back) | new token]
        hist = torch.cat([state["conv"].to(cd), xin], dim=1)
        xcv = F.silu(torch.einsum("bwc,wc->bc", hist, w) + b)[:, None]
        new_conv = hist[:, 1:]
    else:
        xcv = _conv_full(xin, w, b)
        new_conv = (xin[:, S - (xc_cfg.conv_width - 1):, :].to(f32)
                    if ctx.phase == "prefill" else None)

    q = _proj(xcv, p["w_q"], cd)
    # the scale rounded to the compute dtype first, as JAX's weak type does
    k = _proj(xcv, p["w_k"], cd) * float(torch.tensor(N ** -0.5, dtype=cd))
    v = _proj(xin, p["w_v"], cd)
    gates = mm(xcv, p["w_gates"].to(cd)).to(f32) + p["gate_bias"].to(f32)
    i_gate = torch.sigmoid(gates[..., :H])               # [B,S,H]
    log_f = F.logsigmoid(gates[..., H:])                 # [B,S,H]

    k_in = k * i_gate[..., None].to(cd)
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    v_aug = torch.cat([v, ones], dim=-1)                 # normalizer channel

    if ctx.is_decode:
        mem, y_aug = ssd_ops.ssd_step(state["mem"], q[:, 0], k_in[:, 0],
                                      v_aug[:, 0], log_f[:, 0])
        y_aug = y_aug[:, None]
        state["conv"].copy_(new_conv)
        state["mem"].copy_(mem)
        new_state = state
    else:
        y_aug, final = ssd_ops.ssd(q, k_in, v_aug, log_f, chunk=xc_cfg.chunk)
        new_state = ({"conv": new_conv, "mem": final}
                     if ctx.phase == "prefill" else None)

    num = y_aug[..., :N].to(f32)
    den = y_aug[..., N:].to(f32)
    h = num / torch.clamp(den.abs(), min=1.0)
    h = h.reshape(B, -1, d_inner).to(cd)
    h = norms.apply(p["norm"], h, eps=cfg.norm_eps) * F.silu(z)
    out = mm(h.to(cd), p["w_down"].to(cd))
    return ctx.constrain(out, ("act_batch", "act_seq", None)), new_state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def slstm_init(gen, cfg: ModelConfig):
    x = cfg.xlstm
    D = cfg.d_model
    dp = int(D * x.slstm_proj)
    params, specs = iu.split_tree({
        "w_x": iu.dense(gen, (D, 4 * D), ("fsdp", "tp")),
        "w_h": iu.dense(gen, (D, 4 * D), ("fsdp", "tp")),
        "bias": iu.zeros((4 * D,), ("tp",), device=gen.device),
        "w_ff1": iu.dense(gen, (D, dp), ("fsdp", "tp")),
        "w_ff2": iu.dense(gen, (dp, D), ("tp", "fsdp"),
                          scale=1.0 / dp ** 0.5),
    })
    np_, ns = norms.init(gen, D)
    params["norm"], specs["norm"] = np_, ns
    return params, specs


SLSTM_STATE = ("h", "c", "n", "m")


def slstm_state_spec(cfg: ModelConfig, batch: int, cache_len: int):
    del cache_len
    sp = ("act_batch", None)
    return {k: ((batch, cfg.d_model), torch.float32, sp)
            for k in SLSTM_STATE}


def _slstm_cell_from_gx(w_h, carry, gx_t):
    """One sLSTM step with exponential gating and stabilizer (paper eq.
    19).  ``gx_t = x_t @ w_x + bias`` is computed for the whole sequence
    before the loop; a step does the h-dependent half.  h is carried in
    the compute dtype, c, n and m in f32."""
    h, c, n, m = carry
    g = gx_t.to(torch.float32) + (h @ w_h).to(torch.float32)
    i_raw, f_raw, z_raw, o_raw = torch.chunk(g, 4, dim=-1)
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_raw)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new.to(gx_t.dtype), c_new, n_new, m_new)


def slstm_apply(p, x, state, ctx: Ctx, *, cfg: ModelConfig):
    cd = ctx.cdtype
    B, S, D = x.shape
    if state is None:
        zero = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        carry = (zero, zero, zero, zero)
    else:
        carry = tuple(state[k] for k in SLSTM_STATE)

    xn = norms.apply(p["norm"], x, eps=cfg.norm_eps)
    # x-side gates: one matmul over the whole sequence
    gx = mm(xn.to(cd), p["w_x"].to(cd)) + p["bias"].to(cd)
    w_h = p["w_h"].to(cd)
    # h in the compute dtype, so that the step's matmul stays bf16
    carry = (carry[0].to(cd),) + carry[1:]

    if ctx.is_decode:
        carry = _slstm_cell_from_gx(w_h, carry, gx[:, 0])
        h_seq = carry[0][:, None]
    else:
        hs = []
        for t in range(S):
            carry = _slstm_cell_from_gx(w_h, carry, gx[:, t])
            hs.append(carry[0])
        h_seq = torch.stack(hs, dim=1)                    # [B,S,D]

    new_state = None
    if ctx.is_decode:
        for k, v in zip(SLSTM_STATE, carry):
            state[k].copy_(v)
        new_state = state
    elif ctx.phase == "prefill":
        new_state = {"h": carry[0].to(torch.float32), "c": carry[1],
                     "n": carry[2], "m": carry[3]}

    h_seq = h_seq.to(cd)
    ff = F.gelu(mm(h_seq, p["w_ff1"].to(cd)), approximate="tanh")
    out = mm(ff, p["w_ff2"].to(cd))
    return ctx.constrain(out, ("act_batch", "act_seq", None)), new_state
