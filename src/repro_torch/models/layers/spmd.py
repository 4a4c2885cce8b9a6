"""Activation operations whose DTensor rule needs help on a mesh.

``mm``: ``x @ w`` for activations ``x [B, S, D]`` and a weight ``w [D,
K]``.  A plain product folds ``B`` and ``S`` into one dim before its matrix
product.  On a mesh where both are split (the residual stream in
training and prefill: batch over the data axes, sequence over "model"),
the folded dim is a strided shard, and DTensor searches for that dim's
redistributions for minutes an op on a three-axis mesh.  Such an ``x``
is multiplied as a batched product over ``B`` instead (``w`` broadcast,
no copy), which keeps every rank's rows where they are; anything else,
every tensor on one card included, takes the plain product.

``unflatten_last`` splits a product's last dim into heads and
``flatten_last`` joins the heads of an attention output: DTensor's
sharding propagation may split the joined dim over a mesh axis whose
size does not divide the head count (qwen2's 14 heads on 16 ranks),
which no view can keep, so that axis is gathered first -- in the
forward before ``unflatten_last``, in the backward (where the gradient
of the joined dim is split that way) before ``flatten_last``'s
gradient is split back into heads.

``argmax_last`` takes the argmax of the last dim with that dim whole:
DTensor's own rule for ``argmax`` over a split dim reshapes the rank's
candidates into an invalid shape on a two-axis mesh (the vocab-split
logits of a decode step, torch 2.13), so each mesh dim that splits it
is gathered first, on the device, and ties go to the first maximal
index as on the whole tensor.

``pad_seq`` pads the sequence dim of a DTensor shard by shard, its
sequence gathered first where it is split: DTensor's own rule for
``pad`` gives a malformed placement on a two-axis mesh in some torch
releases (2.11).

Every one of them is the plain operation on a tensor that is not a
DTensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._local import split_dims


def mm(x, w):
    if x.ndim == 3 and {0, 1} <= split_dims(x):
        return torch.bmm(x, w.expand(x.shape[0], *w.shape))
    return x @ w


def _heads_whole(y, H: int):
    """DTensor ``y`` with its last dim gathered over every mesh axis that
    splits it into pieces ``H`` heads do not divide into."""
    from torch.distributed.tensor import Replicate
    last, mesh = y.ndim - 1, y.device_mesh
    pl = tuple(Replicate() if p.is_shard(last) and H % mesh.size(i)
               else p for i, p in enumerate(y.placements))
    return y if pl == tuple(y.placements) else y.redistribute(mesh, pl)


def argmax_last(x):
    """``torch.argmax(x, -1)``, the last dim of a DTensor made whole on
    every mesh dim that splits it."""
    if hasattr(x, "device_mesh"):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        pl = tuple(Replicate() if p.is_shard(last) else p
                   for p in x.placements)
        if pl != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return torch.argmax(x, -1)


def unflatten_last(y, H: int, K: int):
    """``y [..., H * K]`` -> ``[..., H, K]``."""
    if hasattr(y, "device_mesh"):
        y = _heads_whole(y, H)
    return y.unflatten(-1, (H, K))


class _FlattenHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.H, ctx.K = y.shape[-2:]
        return y.flatten(-2)

    @staticmethod
    def backward(ctx, g):
        return _heads_whole(g, ctx.H).unflatten(-1, (ctx.H, ctx.K))


def flatten_last(y):
    """``y [..., H, K]`` -> ``[..., H * K]``."""
    if hasattr(y, "device_mesh"):
        return _FlattenHeads.apply(y)
    return y.flatten(-2)


def pad_seq(t, before: int, after: int, value=0):
    """``t`` [B, S, ...] with ``before`` / ``after`` positions of
    ``value`` added on the sequence dim."""
    widths = (0, 0) * (t.ndim - 2) + (before, after)
    if not hasattr(t, "device_mesh"):
        return torch.nn.functional.pad(t, widths, value=value)
    from torch.distributed.tensor import DTensor, Replicate
    pl = tuple(Replicate() if p.is_partial() or p.is_shard(1) else p
               for p in t.placements)
    if pl != tuple(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return DTensor.from_local(
        torch.nn.functional.pad(t.to_local(), widths, value=value),
        t.device_mesh, pl, run_check=False)
