"""Dispatching wrapper for the chunked SSD linear recurrence (port of
``repro/kernels/ssd/ops.py``).

``impl``:
  - "auto": the ``ssd_scan`` CUDA kernel for a CUDA ``q`` whose shape the
    kernel's ``supported()`` takes and no ``initial_state`` (the JAX
    package's own rule for its Pallas kernel), else the plain version
  - "cuda": the kernel (raises for CPU tensors or a shape it cannot take;
    it starts from ``initial_state`` where one is given)
  - "ref": the plain PyTorch version

``ssd_step``, the decode recurrence, has no kernel in either package.

On DTensors (a mesh) either route runs on each rank's local shards
(``kernels/_local.py``): the batch and head shards the four inputs
share are kept.  Where the sequence is split across ranks (the prefill
rules shard it over "model"), the split stays and the carried state
crosses ranks (:func:`_carried`): each rank scans its slice from zero
and takes its slice's decay ``A_r = exp(sum log_a)``; one all-gather a
split mesh dim brings every rank's ``(final_r, A_r)``; a fold in rank
order gives each rank the state the ranks before it carry, ``h0_r =
sum_{j<r} (prod_{j<i<r} A_i) final_j`` (plus ``prod_{j<r} A_j`` times
``initial_state``, where one is given), from which ranks ``r > 0`` (and
rank 0 from a given ``initial_state``) scan their slice again; the
returned final state is the fold over every rank, the same on each.  There "auto"
takes the kernel for a CUDA ``q`` whose shape it supports, the second
scan's initial state included: the route never falls back to the plain
version on the card.

The kernel has no backward yet (ROADMAP queue 1 item 22): where the
kernel would run and an input needs a gradient (training zamba2 on the
card), ``ssd`` raises rather than differentiating the plain version in
its place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _local
from repro_torch.kernels.ssd import ref as _ref
from repro_torch.kernels.ssd_scan import kernel as _k

ssd_step = _ref.ssd_step


def fold(final, decay, me: int):
    """The carry across R consecutive slices: ``final [R,B,H,N,P]`` (each
    slice's final state from zero) and ``decay [R,B,H]`` (each slice's
    ``exp(sum log_a)``), folded in rank order.  Returns ``(h0, a0, h,
    a)``: the state entering slice ``me`` and the decay from the first
    slice's start to it, then the state after the last slice and the
    whole decay."""
    h = torch.zeros_like(final[0])
    a = torch.ones_like(decay[0])
    h0 = a0 = None
    for j in range(final.shape[0]):
        if j == me:
            h0, a0 = h, a
        h = decay[j][..., None, None] * h + final[j]
        a = decay[j] * a
    return h0, a0, h, a


def _carried(q, k, v, log_a, chunk, init, impl, mesh, split, mine):
    """A rank's slice scanned (by ``impl``, "cuda" or "ref") with the
    state carried across the ranks of the mesh dims ``split``: its first
    scan from zero, one all-gather of ``(final, decay)`` a split mesh dim
    (minor first: each level's members are the last level's consecutive
    groups), the fold, the initial state ``init`` carried in last (every
    rank's start state and the final state take it), and a second scan
    from the carried state where the slice is not the first or ``init``
    is given.  Returns ``(y, final)``, ``final`` the state after the last
    slice."""
    f32 = torch.float32
    y, F = ssd(q, k, v, log_a, chunk=chunk, impl=impl)
    A = torch.exp(log_a.to(f32).sum(1))                # [B, H]
    # this slice's start state is a0 * (its group's start state) + h0
    h0 = torch.zeros_like(F)
    a0 = torch.ones_like(A)
    NP = F.shape[2] * F.shape[3]
    for i in reversed(split):
        got = _local.gather_ranks(torch.cat([F.flatten(2), A[..., None]],
                                            -1), mesh, i)
        hp, ap, F, A = fold(got[..., :NP].unflatten(-1, F.shape[2:]),
                            got[..., NP], mine[i])
        h0 = a0[..., None, None] * hp + h0
        a0 = a0 * ap
    if init is not None:
        h0 = a0[..., None, None] * init + h0
        F = A[..., None, None] * init + F
    if init is not None or any(mine[i] for i in split):
        y, _ = ssd(q, k, v, log_a, chunk=chunk, initial_state=h0, impl=impl)
    return y, _local.replicated(F, mesh, split)


def _on_shards(q, k, v, log_a, chunk, initial_state, impl):
    from torch.distributed.tensor import Replicate, Shard
    split = [i for i in _local.split_mesh_dims(q, 1)
             if all(i in _local.split_mesh_dims(t, 1) for t in (k, v, log_a))]
    pls = [list(p) for p in _local.common_placements((q, k, v, log_a),
                                                     ((0, 2),) * 4)]
    for i in split:
        for p in pls:
            p[i] = Shard(1)
    pls = [tuple(p) for p in pls]
    # states [B,H,N,P]: q's head dim 2 is their dim 1, whole over split
    fp = tuple(Shard(1) if p == Shard(2) else
               Replicate() if p == Shard(1) else p for p in pls[2])
    if _local.is_dtensor(initial_state):
        initial_state = _local.to_local(initial_state, fp,
                                        _local.partial_grads(fp, split))
    ql, kl, vl, ll = (_local.to_local(t, pl) for t, pl in
                      zip((q, k, v, log_a), pls))
    if not split:
        y, final = ssd(ql, kl, vl, ll, chunk=chunk,
                       initial_state=initial_state, impl=impl)
    else:
        mesh = q.device_mesh
        kernel = impl == "cuda" or (impl == "auto" and ql.is_cuda
                                    and _k.supported(ql, kl, vl))
        y, final = _carried(ql, kl, vl, ll, chunk, initial_state,
                            "cuda" if kernel else "ref", mesh, split,
                            {i: mesh.get_local_rank(i) for i in split})
    return (_local.from_local(y, q, pls[2], v.shape),
            _local.from_local(final, q, fp))


def ssd(q, k, v, log_a, *, chunk: int = 256, initial_state=None,
        impl: str = "auto"):
    if _local.is_dtensor(q):
        return _on_shards(q, k, v, log_a, chunk, initial_state, impl)
    if impl == "auto":
        impl = "cuda" if (q.is_cuda and initial_state is None
                          and _k.supported(q, k, v)) else "ref"
    if impl == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, log_a)):
            raise NotImplementedError(
                "ssd_scan kernel: no backward kernel yet, so the chunked "
                "SSD scan cannot be trained on the card (ROADMAP queue 1 "
                "item 22)")
        return _k.ssd_scan(q, k, v, log_a, chunk=chunk,
                           initial_state=initial_state)
    if impl != "ref":
        raise ValueError(f"unknown ssd impl {impl!r}")
    return _ref.ssd(q, k, v, log_a, chunk=chunk,
                    initial_state=initial_state)
