"""Dispatching wrapper for attention (port of ``repro/kernels/attention/
ops.py``).

``impl``:
  - "auto": the ``flash_attention`` CUDA kernel for a CUDA ``q``, the
    plain version for a CPU ``q``
  - "cuda": the kernel (raises for CPU tensors or a shape it cannot take)
  - "ref": the plain PyTorch version
"""
from __future__ import annotations

from repro_torch.kernels.attention import ref as _ref


def mha(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
        chunk: int = 512, impl: str = "auto"):
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "cuda":
        from repro_torch.kernels.flash_attention import kernel as _k
        return _k.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    if impl != "ref":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _ref.mha(q, k, v, causal=causal, window=window,
                    q_offset=q_offset, chunk=chunk)
