"""Dispatching wrapper for decode attention (port of
``repro/kernels/decode_attention/ops.py``).

``impl``:
  - "auto": the ``decode_attention`` CUDA kernel for a CUDA ``q``, the
    plain version for a CPU ``q``
  - "cuda": the kernel (raises for CPU tensors or a shape it cannot take)
  - "ref": the plain PyTorch version
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import ref as _ref


def decode_attend(q, k_cache, v_cache, lengths, *, window: int = 0,
                  impl: str = "auto"):
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "cuda":
        from repro_torch.kernels.decode_attention import kernel as _k
        return _k.decode_attention(q, k_cache, v_cache, lengths,
                                   window=window)
    if impl != "ref":
        raise ValueError(f"unknown decode_attention impl {impl!r}")
    return _ref.decode_attend(q, k_cache, v_cache, lengths, window=window)
