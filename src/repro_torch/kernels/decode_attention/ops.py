"""Dispatching wrapper for decode attention (port of
``repro/kernels/decode_attention/ops.py``).

``impl``:
  - "auto": the ``decode_attention`` CUDA kernel for a CUDA ``q``, the
    plain version for a CPU ``q``
  - "cuda": the kernel (raises for CPU tensors or a shape it cannot take)
  - "ref": the plain PyTorch version

On DTensors (a mesh) either route runs on each rank's local shards
(``kernels/_local.py``): the batch and head shards q and the caches
share are kept.  A cache whose sequence is split across ranks is
gathered first for the plain version and raises for the kernel: its
softmax partials would need a combine across ranks (ROADMAP queue 1
item 15d).
"""
from __future__ import annotations

from repro_torch.kernels import _local
from repro_torch.kernels.decode_attention import ref as _ref


def _on_shards(fn, q, k_cache, v_cache, lengths, window, kernel):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if kernel:
        for c in (k_cache, v_cache):
            _local.refuse_split("decode_attention", c, 1,
                                "cache's sequence")
    pls = _local.common_placements((q, k_cache, v_cache), ((0, 2),) * 3)
    if not _local.is_dtensor(lengths):
        lengths = DTensor.from_local(lengths, q.device_mesh,
                                     (Replicate(),) * q.device_mesh.ndim,
                                     run_check=False)
    lp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pls[0])
    o = fn(*(_local.to_local(t, pl) for t, pl in zip((q, k_cache, v_cache),
                                                     pls)),
           _local.to_local(lengths, lp), window=window)
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
        return _on_shards(fn, q, k_cache, v_cache, lengths, window,
                          kernel=impl == "cuda")
    return fn(q, k_cache, v_cache, lengths, window=window)
