"""Dispatching wrapper for decode attention (port of
``repro/kernels/decode_attention/ops.py``).

``impl``:
  - "auto": the ``decode_attention`` CUDA kernel for a CUDA ``q``, the
    plain version for a CPU ``q``
  - "cuda": the kernel (raises for CPU tensors or a shape it cannot take)
  - "ref": the plain PyTorch version

On DTensors (a mesh) either route runs on each rank's local shards
(``kernels/_local.py``): the batch and head shards q and the caches
share are kept.  Where the caches' sequence is split across ranks (the
serving rules shard it over "model"), the split stays: each rank
attends over its slice of the cache at its offset (the kernel's, or the
plain version's, ``partial`` route: ``(o, lse)`` in f32), one all-gather
a split mesh dim brings every rank's partials, and :func:`merge`
combines them -- flash-decoding's split-K, which GSPMD
does for the JAX package with a psum.  q is whole over those mesh dims,
and so is the output.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _local
from repro_torch.kernels.decode_attention import ref as _ref


def merge(o, lse):
    """Partials over R slices of one cache -> the whole cache's: ``o [R,
    B,Sq,H,Dv]`` and ``lse [R,B,Sq,H]`` (f32) give ``(o, lse)`` with
    ``m = max_r lse_r``, ``o = sum_r e^(lse_r - m) o_r / sum_r
    e^(lse_r - m)``, ``lse = m + log(sum_r e^(lse_r - m))``, in f32.  A
    row no slice saw (every ``lse`` -inf) gives ``o = 0`` and ``lse =
    -inf``, as the kernel gives a row with no visible key; the whole-tensor plain version gives such a row (a
    length of 0) the mean of v instead (its masked scores are finite).
    Serving never asks for it: a slot's length is at least 1."""
    m = lse.amax(0)
    seen = torch.isfinite(m)
    w = torch.exp(lse - torch.where(seen, m, 0.0))
    # 1 where nothing is seen: no 0 reaches the log or its gradient
    den = torch.where(seen, w.sum(0), 1.0)
    out = torch.where(seen[..., None],
                      (w[..., None] * o).sum(0) / den[..., None], 0.0)
    return out, torch.where(seen, m + torch.log(den), -torch.inf)


def _seq_split(q, k_cache, v_cache):
    """The mesh dims that split both caches' sequence."""
    ks = _local.split_mesh_dims(k_cache, 1)
    return [i for i in ks if i in _local.split_mesh_dims(v_cache, 1)]


def _on_shards(fn, q, k_cache, v_cache, lengths, window):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    split = _seq_split(q, k_cache, v_cache)
    pls = [list(p) for p in _local.common_placements(
        (q, k_cache, v_cache), ((0, 2),) * 3)]
    for i in split:            # q whole there, the caches' slices kept
        pls[0][i], pls[1][i], pls[2][i] = Replicate(), Shard(1), Shard(1)
    pls = [tuple(p) for p in pls]
    if not _local.is_dtensor(lengths):
        lengths = DTensor.from_local(lengths, q.device_mesh,
                                     (Replicate(),) * q.device_mesh.ndim,
                                     run_check=False)
    lp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pls[0])
    ql = _local.to_local(q, pls[0], _local.partial_grads(pls[0], split))
    kl, vl = (_local.to_local(t, pl) for t, pl in
              zip((k_cache, v_cache), pls[1:]))
    lens = _local.to_local(lengths, lp)
    if not split:
        return _local.from_local(fn(ql, kl, vl, lens, window=window), q,
                                 pls[0])
    o, lse = fn(ql, kl, vl, lens, window=window, partial=True,
                seq_offset=_local.offset(k_cache, 1, pls[1]),
                seq_total=k_cache.shape[1])
    mesh = q.device_mesh
    for i in split:            # one all-gather of the packed partials
        Dv = o.shape[-1]
        got = _local.gather_ranks(torch.cat([o, lse[..., None]], -1),
                                  mesh, i)
        o, lse = merge(got[..., :Dv], got[..., Dv])
    o = _local.replicated(o.to(q.dtype), mesh, split)
    return _local.from_local(o, q, pls[0])


def decode_attend(q, k_cache, v_cache, lengths, *, window: int = 0,
                  impl: str = "auto"):
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "cuda":
        from repro_torch.kernels.decode_attention import kernel as _k
        fn = _k.decode_attention
    elif impl == "ref":
        fn = _ref.decode_attend
    else:
        raise ValueError(f"unknown decode_attention impl {impl!r}")
    if _local.is_dtensor(q):
        return _on_shards(fn, q, k_cache, v_cache, lengths, window)
    return fn(q, k_cache, v_cache, lengths, window=window)
