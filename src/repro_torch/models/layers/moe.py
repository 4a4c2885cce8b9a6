"""Fine-grained MoE sublayer, DeepSeekMoE: shared and routed top-k
experts (port of ``repro.models.layers.moe``).

Dispatch is sort-based with a fixed expert capacity, as in the JAX
package: each token goes to ``top_k`` experts, each expert's buffer holds
``cap`` entries, and entries past it are dropped (the engine's
bounded-queue overflow, DESIGN.md section 2).  The stable sort keeps the
first ``cap`` entries of each expert in token order.  The expert FFN is
three batched products over the experts.

The combine is deterministic: the JAX package sums each token's ``top_k``
contributions with ``segment_sum``; the port inverts the sort and sums
them in a fixed order (no float atomics), so a run repeats bit for bit.

The JAX package's expert-parallel path (``apply_sharded``, a shard_map
over a mesh) waits for the multi-card slice (ROADMAP queue 1 item 16b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import init_utils as iu
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import ffn


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def init(gen, cfg: ModelConfig):
    m = cfg.moe
    D = cfg.d_model
    params, specs = iu.split_tree({
        "router": iu.dense(gen, (D, m.n_routed_experts), (None, None),
                           scale=0.02),
        "w_gate": iu.dense(gen, (m.n_routed_experts, D, m.d_expert),
                           ("tp", "fsdp", None)),
        "w_in": iu.dense(gen, (m.n_routed_experts, D, m.d_expert),
                         ("tp", "fsdp", None)),
        "w_out": iu.dense(gen, (m.n_routed_experts, m.d_expert, D),
                          ("tp", None, "fsdp"),
                          scale=1.0 / m.d_expert ** 0.5),
    })
    if m.n_shared_experts:
        sp, ss = ffn.init(gen, D, m.n_shared_experts * m.d_expert)
        params["shared"], specs["shared"] = sp, ss
    return params, specs


def capacity(T: int, m: MoEConfig) -> int:
    """Entries an expert's buffer holds for ``T`` tokens."""
    K, E = m.top_k, m.n_routed_experts
    return min(_round_up(max(int(T * K / E * m.capacity_factor), 1), 8),
               T * K)


def route(router, xt, m: MoEConfig):
    """f32 routing of tokens ``xt [T, D]``: the renormalised top-k gates
    and expert ids ``[T, K]`` (descending probability) and the Switch
    load-balance loss ``E * sum_e f_e * p_e`` times its coefficient."""
    K, E = m.top_k, m.n_routed_experts
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # [T,E]
    gate, expert_ids = torch.topk(probs, K, dim=-1)             # [T,K]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)         # renorm (DS)
    # one_hot of the first expert (as a comparison: F.one_hot checks its
    # input's range on the host)
    assign = (expert_ids[:, :1] == torch.arange(E, device=xt.device)).to(
        torch.float32)
    frac = torch.mean(assign, dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = m.router_aux_coef * E * torch.sum(frac * mean_prob)
    return gate, expert_ids, aux


def dispatch(expert_ids, cap: int):
    """The sort-based dispatch of ``expert_ids [T, K]``: ``order`` (the
    stable sort of the flat entries by expert), and in that order each
    entry's buffer ``slot`` (expert * cap + its rank within the expert)
    and whether it fits (``valid``: rank < cap)."""
    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(se.shape[0], device=se.device) - torch.searchsorted(
        se, se, side="left")
    return order, se * cap + rank, rank < cap


def apply(p, x, ctx: Ctx, *, cfg: ModelConfig):
    """x [B,S,D] -> (y [B,S,D] in x's dtype, aux loss): the JAX package's
    ``_apply_global``, every expert on one card."""
    m = cfg.moe
    cd = ctx.cdtype
    B, S, D = x.shape
    T = B * S
    K, E = m.top_k, m.n_routed_experts
    xt = x.reshape(T, D)

    gate, expert_ids, aux = route(p["router"], xt, m)
    cap = capacity(T, m)
    order, slot, valid = dispatch(expert_ids, cap)
    st = order // K                                  # each entry's token
    sw = gate.reshape(-1)[order]
    # dropped entries land in a sink row past the buffers
    slot_safe = torch.where(valid, slot, E * cap)
    buf = torch.zeros((E * cap + 1, D), dtype=cd, device=x.device)
    buf[slot_safe] = xt[st].to(cd)
    buf = buf[:E * cap].view(E, cap, D)

    # ---- expert FFN (gated), batched over the experts ----
    h = F.silu(torch.bmm(buf, p["w_gate"].to(cd)))
    h = h * torch.bmm(buf, p["w_in"].to(cd))
    out_e = torch.bmm(h, p["w_out"].to(cd))

    # ---- combine: back to token order, each token's K entries summed ----
    contrib = out_e.reshape(E * cap, D)[torch.where(valid, slot, 0)]
    contrib = contrib * (sw * valid).to(cd)[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    y = contrib[inv].view(T, K, D).sum(dim=1)

    if "shared" in p:
        y = y + ffn.apply(p["shared"], xt[None], ctx, act="silu")[0]
    return y.reshape(B, S, D).to(x.dtype), aux
