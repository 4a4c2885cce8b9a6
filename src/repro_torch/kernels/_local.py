"""Kernel routes on DTensors: each kernel sees its rank's local shards.

A kernel wrapper launches on a CUDA tensor's data pointer, so a DTensor
never reaches it.  The dispatchers (``kernels/*/ops.py``) bring their
DTensor inputs to placements under which the kernel's work splits into
independent local pieces -- shards of the dims every input shares
(batch, heads) are kept, anything else is gathered -- run the kernel on
the local shards, and wrap its output back into a DTensor.

Where a dim the kernel reduces over is split over a mesh dim of more
than one rank (a decode cache's sequence, a prefill's sequence through
the SSD scan, a norm's row), the route keeps that split and does four
things: the rank's **local partials** (the kernel, or the plain version,
by ``impl``, on the rank's slice at its :func:`offset`), **one
all-gather** of the partials over that mesh dim's group
(:func:`gather_ranks`), a **merge** (a pure function of the partials
stacked in rank order, in each ``ops.py``), and ``from_local``.  Both
impls take that path, so the CPU's gloo ranks run the code the card
runs.  No all-reduce: its order is not fixed, while every rank sums the
same gathered stack alike, so the result has the same bits on every rank
and every call.

Under autograd the gather's backward sums every rank's gradient of the
stack (:func:`gather_ranks`), which is right for outputs each rank holds
a piece of.  An output every rank of the split computes alike (a
``Replicate`` one) passes :func:`replicated`, which counts its gradient
on the first rank only, and an input whole over the split takes
:func:`partial_grads` as its gradient's placements, so each rank's piece
of it is summed.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def is_dtensor(t) -> bool:
    # by its attributes: importing torch.distributed.tensor takes a
    # second, which a process with no mesh never pays
    return hasattr(t, "device_mesh") and hasattr(t, "placements")


def split_dims(t) -> set:
    """The dims of ``t`` sharded over a mesh dim of more than one rank
    (none when ``t`` is not a DTensor)."""
    if not is_dtensor(t):
        return set()
    mesh = t.device_mesh
    return {p.dim for i, p in enumerate(t.placements)
            if p.is_shard() and mesh.size(i) > 1}


def split_mesh_dims(t, dim: int) -> list:
    """The mesh dims of more than one rank that shard ``t``'s ``dim``, in
    mesh order (none when ``t`` is not a DTensor)."""
    if not is_dtensor(t):
        return []
    d = dim % t.ndim
    return [i for i, p in enumerate(t.placements)
            if p.is_shard(d) and t.device_mesh.size(i) > 1]


def offset(t, dim: int, placements=None) -> int:
    """The global index of this rank's first element along ``dim`` of
    DTensor ``t`` (in ``placements``, default its own): from the shard
    sizes, so an uneven split (the last ranks shorter, as ``Shard`` cuts
    it) is placed right."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    _, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, tuple(placements or t.placements))
    return int(off[dim % t.ndim])


# every all-gather the cross-rank routes issued, backward ones included
GATHERS = {"all_gather": 0}


def _all_gather(x: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """``[R, *x.shape]``: every rank's ``x`` along ``mesh_dim``'s group, in
    mesh order along that dim (the order of ``Shard``'s pieces).  A
    functional collective, as DTensor's own gathers are, so the dry run's
    cost counter sees it."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    # all_gather_tensor's new name in later torch releases
    gather = getattr(fc, "all_gather_single", fc.all_gather_tensor)
    GATHERS["all_gather"] += 1
    got = fc.wait_tensor(gather(x.contiguous()[None], 0, (mesh, mesh_dim)))
    # group rank -> the mesh's order along mesh_dim
    ranks = dist.get_process_group_ranks(mesh.get_group(mesh_dim))
    idx = list(mesh.get_coordinate())
    idx[mesh_dim] = slice(None)
    order = [ranks.index(g) for g in mesh.mesh[tuple(idx)].tolist()]
    return got if order == sorted(order) else got[order]


class _Gather(torch.autograd.Function):
    """:func:`_all_gather` with a backward in the same shape: every rank's
    gradient of the stacked partials gathered, summed over the ranks, and
    this rank's row kept."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_dim):
        ctx.mesh, ctx.mesh_dim = mesh, mesh_dim
        return _all_gather(x, mesh, mesh_dim)

    @staticmethod
    def backward(ctx, g):
        gs = _all_gather(g, ctx.mesh, ctx.mesh_dim)   # [R_src, R, ...]
        return gs[:, ctx.mesh.get_local_rank(ctx.mesh_dim)].sum(0), \
            None, None


def gather_ranks(x: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """Every rank's partial ``x`` stacked ``[R, *x.shape]`` in rank order
    along ``mesh_dim``: one all-gather over that mesh dim's group
    (differentiable, for the plain routes under autograd)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, mesh, mesh_dim)
    return _all_gather(x, mesh, mesh_dim)


class _Once(torch.autograd.Function):
    """The identity; its backward keeps the gradient where ``keep``, else
    gives zeros."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def replicated(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``x``, which every rank of the mesh dims ``dims`` computes alike
    from gathered partials (an output whole over them): every rank
    receives its whole gradient, so only the first rank of ``dims`` passes
    it on, and the gathers' backward, a sum over the ranks, counts it
    once."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Once.apply(x, not any(mesh.get_local_rank(i) for i in dims))
    return x


def partial_grads(placements, dims) -> tuple:
    """An input's ``placements`` with ``Partial`` on the mesh dims ``dims``
    (where it is whole while the route splits another input): each rank's
    gradient of it is its own slice's share, summed over those ranks."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if i in dims else p
                 for i, p in enumerate(placements))


def common_placements(tensors: Sequence, dims: Sequence[Tuple[int, ...]]):
    """One placement per mesh dim for every tensor: ``Shard(dims[j][k])``
    on tensor ``j`` where every tensor is sharded there on its ``k``-th
    kept dim, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = tensors[0].device_mesh
    out = [[] for _ in tensors]
    for i in range(mesh.ndim):
        kept = None
        for k in range(len(dims[0])):
            if all(t.placements[i] == Shard(d[k])
                   for t, d in zip(tensors, dims)):
                kept = k
                break
        for j, d in enumerate(dims):
            out[j].append(Replicate() if kept is None else Shard(d[kept]))
    return [tuple(p) for p in out]


def to_local(t, placements, grad_placements=None) -> torch.Tensor:
    """``t``'s local shard in ``placements`` (redistributed first when it
    is in others)."""
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(t.device_mesh, placements)
    return t.to_local(grad_placements=grad_placements)


def from_local(x: torch.Tensor, like, placements, shape=None):
    """A local kernel output as a DTensor on ``like``'s mesh; ``shape``,
    the global shape, where a split it keeps may be uneven (else it is
    inferred from even shards)."""
    from torch.distributed.tensor import DTensor
    if shape is None:
        return DTensor.from_local(x, like.device_mesh, placements,
                                  run_check=False)
    shape = torch.Size(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(x, like.device_mesh, placements,
                              run_check=False, shape=shape,
                              stride=tuple(stride))
