"""Dispatching wrapper for RMSNorm (port of ``repro/kernels/rmsnorm/
ops.py``).

``impl``:
  - "auto": the ``rmsnorm`` CUDA kernel for a CUDA ``x``, the plain
    version for a CPU ``x``
  - "cuda": the kernel (raises for CPU tensors or a layout it cannot take)
  - "ref": the plain PyTorch version
"""
from __future__ import annotations

from repro_torch.kernels.rmsnorm import ref as _ref


def rmsnorm(x, w, *, eps: float = 1e-6, scale_offset: bool = False,
            impl: str = "auto"):
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "cuda":
        from repro_torch.kernels.rmsnorm import kernel as _k
        return _k.rmsnorm(x, w, eps=eps, scale_offset=scale_offset)
    if impl != "ref":
        raise ValueError(f"unknown rmsnorm impl {impl!r}")
    return _ref.rmsnorm(x, w, eps=eps, scale_offset=scale_offset)
