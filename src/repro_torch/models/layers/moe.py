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

On a mesh whose rules put the experts on "model" (``_sharded_ok``;
not in decode), ``apply`` takes the expert-parallel path,
``apply_sharded``: the JAX package's shard_map region, written on local
shards.  Each (pod, data, seq) token shard routes its own tokens,
buckets them by the "model" rank that owns their expert (``cap_send``
entries a destination), exchanges the buckets with one
``all_to_all_single`` each way over the "model" group, sorts what it
received by local expert (``cap_exp`` entries an expert) and runs its
experts, whose FSDP-sharded weights it first ``all_gather``s over the
data axes.  The load-balance loss is each shard's own, averaged over
"model" and then over the data axes, as JAX's ``pmean``s give it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
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
    """x [B,S,D] -> (y [B,S,D] in x's dtype, aux loss)."""
    if ctx.mesh is not None and _sharded_ok(cfg, ctx):
        return apply_sharded(p, x, ctx, cfg=cfg)
    return _apply_global(p, x, ctx, cfg=cfg)


def _apply_global(p, x, ctx: Ctx, *, cfg: ModelConfig):
    """Every expert over all the tokens (on one card, or on a mesh in
    decode)."""
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
    buf = ctx.constrain(buf, ("experts", None, None))

    # ---- expert FFN (gated), batched over the experts ----
    h = F.silu(torch.bmm(buf, p["w_gate"].to(cd)))
    h = h * torch.bmm(buf, p["w_in"].to(cd))
    h = ctx.constrain(h, ("experts", None, None))
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


# --------------------------------------------------------------------------
# explicit expert-parallel dispatch
# --------------------------------------------------------------------------

def _sharded_ok(cfg: ModelConfig, ctx: Ctx) -> bool:
    m = cfg.moe
    rules = ctx.rules or {}
    if rules.get("experts", ()) != ("model",):
        return False
    M = shd.axis_size(ctx.mesh, "model")
    return m.n_routed_experts % M == 0 and ctx.phase != "decode"


class _AllToAll(torch.autograd.Function):
    """An equal-split ``all_to_all_single`` over ``group`` (a (mesh, mesh
    dim) pair); its backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as fc
        ctx.group = group
        return fc.wait_tensor(fc.all_to_all_single(x.contiguous(), None,
                                                   None, group))

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.forward(ctx, g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """``all_gather`` on dim 0 over ``group``; its backward sums the
    gradient's pieces back to their ranks (``reduce_scatter``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as fc
        ctx.group = group
        return fc.wait_tensor(fc.all_gather_tensor(x.contiguous(), 0, group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as fc
        return fc.wait_tensor(fc.reduce_scatter_tensor(
            g.contiguous(), "sum", 0, ctx.group)), None


def _local_of(t, mesh, placements):
    """The rank's shard of ``t`` in ``placements`` (a DTensor is
    redistributed there first; a plain tensor is the whole tensor, the
    same on every rank).  Differentiable: the shard's gradient is a shard
    on the dims it is sharded on and a partial sum on the others, as a
    shard_map's cotangent is psummed over the axes its spec leaves out."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t.to_local(grad_placements=[
        pl if pl.is_shard() else Partial() for pl in placements])


def apply_sharded(p, x, ctx: Ctx, *, cfg: ModelConfig):
    """The expert-parallel MoE (module docstring): ``x`` [B,S,D] a DTensor
    (or a whole tensor, the same on every rank, whose ``y`` comes back
    whole), the experts split over "model"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    m = cfg.moe
    cd = ctx.cdtype
    B, S, D = x.shape
    K, E = m.top_k, m.n_routed_experts
    mesh, rules = ctx.mesh, ctx.rules
    names = shd.axis_names(mesh)
    fsdp = rules.get("act_batch", ())
    seq_ax = rules.get("act_seq", ())
    M = shd.axis_size(mesh, "model")
    E_loc = E // M
    tp_dim = names.index("model")

    b_shard = fsdp if fsdp and B % shd.axis_prod(mesh, fsdp) == 0 else ()
    s_shard = seq_ax if seq_ax and S % shd.axis_prod(mesh, seq_ax) == 0 \
        else ()
    B_loc = B // shd.axis_prod(mesh, b_shard)
    S_loc = S // shd.axis_prod(mesh, s_shard)
    T_loc = B_loc * S_loc
    cap_send = _round_up(max(int(T_loc * K / M * m.capacity_factor), 8), 8)
    cap_exp = _round_up(max(int(M * cap_send // E_loc), 8), 8)

    ent = lambda axes: None if not axes else (
        axes if len(axes) > 1 else axes[0])
    fs = ent(fsdp)
    x_pl = shd.to_placements((ent(b_shard), ent(s_shard), None), mesh)
    xl = _local_of(x, mesh, x_pl)
    router = _local_of(p["router"], mesh, shd.to_placements((), mesh))
    wg = _local_of(p["w_gate"], mesh, shd.to_placements(("model", fs), mesh))
    wi = _local_of(p["w_in"], mesh, shd.to_placements(("model", fs), mesh))
    wo = _local_of(p["w_out"], mesh,
                   shd.to_placements(("model", None, fs), mesh))

    def gather_fsdp(w, dim):
        # inner axis first, so the pieces land in (pod, data) major order;
        # gathered on dim 0 (the dim moved there and back)
        w = w.movedim(dim, 0)
        for a in reversed(fsdp):
            w = _AllGather.apply(w, (mesh, names.index(a)))
        return w.movedim(0, dim)

    wg_f, wi_f, wo_f = gather_fsdp(wg, 1), gather_fsdp(wi, 1), \
        gather_fsdp(wo, 2)

    xt = xl.reshape(T_loc, D)
    gate, expert_ids, aux = route(router, xt, m)
    # aux: the mean over every rank of the shards' own losses
    aux = DTensor.from_local(aux / mesh.size(), mesh,
                             [Partial()] * mesh.ndim, run_check=False)
    aux = aux.redistribute(mesh, [Replicate()] * mesh.ndim)

    def a2a(v):
        return _AllToAll.apply(v, (mesh, tp_dim))

    # ---- bucket by destination model rank (the experts' owner) ----
    dev = xt.device
    flat_e = expert_ids.reshape(-1)                            # [T_loc*K]
    flat_w = gate.reshape(-1).to(torch.float32)
    dest = flat_e // E_loc
    order = torch.argsort(dest, stable=True)
    sdest, se, sw = dest[order], flat_e[order], flat_w[order]
    st = order // K                                     # each entry's token
    pos = torch.arange(T_loc * K, device=dev) - torch.searchsorted(
        sdest, sdest, side="left")
    ok = pos < cap_send
    slot = torch.where(ok, sdest * cap_send + pos, M * cap_send)
    # dropped entries land in a sink row past the buckets
    send_x = torch.zeros((M * cap_send + 1, D), dtype=cd, device=dev)
    send_x[slot] = xt[st].to(cd)
    send_e = torch.full((M * cap_send + 1,), -1, dtype=torch.int32,
                        device=dev)
    send_e[slot] = (se % E_loc).to(torch.int32)
    recv_x = a2a(send_x[:M * cap_send])                       # [M*cap, D]
    recv_e = a2a(send_e[:M * cap_send])

    # ---- local expert FFN (sort by local expert id) ----
    e_sink = torch.where(recv_e >= 0, recv_e.to(torch.int64), E_loc)
    order2 = torch.argsort(e_sink, stable=True)
    re, rx = e_sink[order2], recv_x[order2]
    pos2 = torch.arange(M * cap_send, device=dev) - torch.searchsorted(
        re, re, side="left")
    ok2 = (re < E_loc) & (pos2 < cap_exp)
    slot2 = torch.where(ok2, re * cap_exp + pos2, E_loc * cap_exp)
    buf = torch.zeros((E_loc * cap_exp + 1, D), dtype=cd, device=dev)
    buf[slot2] = rx
    buf = buf[:E_loc * cap_exp].view(E_loc, cap_exp, D)

    h = F.silu(torch.bmm(buf, wg_f.to(cd)))
    h = h * torch.bmm(buf, wi_f.to(cd))
    out_e = torch.bmm(h, wo_f.to(cd))

    # ---- undo the expert sort, exchange back, combine ----
    flat_out = out_e.reshape(E_loc * cap_exp, D)
    back = torch.empty((M * cap_send, D), dtype=cd, device=dev)
    back[order2] = flat_out[torch.where(ok2, slot2, 0)] * \
        ok2[:, None].to(cd)
    ret = a2a(back)                                      # bucket order
    contrib = ret[torch.where(ok, slot, 0)] * (sw * ok).to(cd)[:, None]
    # each token's K entries summed in a fixed order (no float atomics)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=dev)
    y = contrib[inv].view(T_loc, K, D).sum(dim=1)
    y = y.reshape(B_loc, S_loc, D).to(x.dtype)

    if isinstance(x, DTensor):
        y = DTensor.from_local(y, mesh, x_pl, run_check=False,
                               shape=x.shape, stride=x.stride())
    else:
        y = DTensor.from_local(y, mesh, x_pl, run_check=False).full_tensor()
        aux = aux.full_tensor()
    if "shared" in p:
        y = y + ffn.apply(p["shared"], x, ctx, act="silu")
    return y.to(x.dtype), aux
