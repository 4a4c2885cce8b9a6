"""Dispatching wrapper for RMSNorm (port of ``repro/kernels/rmsnorm/
ops.py``).

``impl``:
  - "auto": the ``rmsnorm`` CUDA kernel for a CUDA ``x``, the plain
    version for a CPU ``x``
  - "cuda": the kernel (raises for CPU tensors or a layout it cannot take)
  - "ref": the plain PyTorch version

Where ``x`` or ``w`` needs a gradient, "cuda" runs the kernel inside
:class:`KernelRMSNorm`, whose backward is the ``rmsnorm_bwd`` kernel; the
plain version is differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import ref as _ref


class KernelRMSNorm(torch.autograd.Function):
    """The ``rmsnorm`` kernel forward, the ``rmsnorm_bwd`` kernel backward
    (``rstd`` recomputed from the saved x: the forward saves nothing
    else)."""

    @staticmethod
    def forward(ctx, x, w, eps, scale_offset):
        from repro_torch.kernels.rmsnorm import kernel as _k
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.scale_offset = eps, scale_offset
        return _k.rmsnorm(x, w, eps=eps, scale_offset=scale_offset)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels.rmsnorm import kernel as _k
        x, w = ctx.saved_tensors
        dx, dw = _k.rmsnorm_bwd(x, w, dy.contiguous(), eps=ctx.eps,
                                scale_offset=ctx.scale_offset)
        return dx, dw, None, None


def rmsnorm(x, w, *, eps: float = 1e-6, scale_offset: bool = False,
            impl: str = "auto"):
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return KernelRMSNorm.apply(x, w, eps, scale_offset)
        from repro_torch.kernels.rmsnorm import kernel as _k
        return _k.rmsnorm(x, w, eps=eps, scale_offset=scale_offset)
    if impl != "ref":
        raise ValueError(f"unknown rmsnorm impl {impl!r}")
    return _ref.rmsnorm(x, w, eps=eps, scale_offset=scale_offset)
