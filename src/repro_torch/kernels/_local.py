"""Kernel routes on DTensors: each kernel sees its rank's local shards.

A kernel wrapper launches on a CUDA tensor's data pointer, so a DTensor
never reaches it.  The dispatchers (``kernels/*/ops.py``) bring their
DTensor inputs to placements under which the kernel's work splits into
independent local pieces -- shards of the dims every input shares
(batch, heads) are kept, anything else is gathered -- run the kernel on
the local shards, and wrap its output back into a DTensor.  Where the
placements shard a dim the kernel reduces over, the local pieces would
need a reduction across ranks inside the kernel: the route raises (the
cross-rank kernels are ROADMAP queue 1 item 15d) and never falls back to
the plain version on the card.
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


def refuse_split(name: str, t, dim: int, what: str) -> None:
    d = dim % t.ndim
    if d in split_dims(t):
        raise NotImplementedError(
            f"{name} kernel on a DTensor whose {what} (dim {d}) is sharded "
            f"({tuple(t.placements)}): the kernel would need a reduction "
            f"across ranks, which waits for ROADMAP queue 1 item 15d")


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


def from_local(x: torch.Tensor, like, placements):
    """A local kernel output as a DTensor on ``like``'s mesh."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, like.device_mesh, placements,
                              run_check=False)
