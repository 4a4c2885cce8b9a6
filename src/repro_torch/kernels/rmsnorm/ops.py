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

On DTensors (a mesh) either route runs on each rank's rows
(``kernels/_local.py``): ``x``'s shards of its leading dims are kept and
``w`` is whole on every rank (its gradient a partial sum over the ranks
that split the rows).  A last dim split across ranks is gathered first
for the plain version and raises for the kernel: its row reduction
would cross ranks (ROADMAP queue 1 item 15d).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _local
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


def _kernel(x, w, eps, scale_offset):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return KernelRMSNorm.apply(x, w, eps, scale_offset)
    from repro_torch.kernels.rmsnorm import kernel as _k
    return _k.rmsnorm(x, w, eps=eps, scale_offset=scale_offset)


def _on_shards(fn, x, w, eps, scale_offset):
    from torch.distributed.tensor import Partial, Replicate
    if fn is _kernel:
        _local.refuse_split("rmsnorm", x, -1, "normalised last dim")
    last = x.ndim - 1
    xp = tuple(p if p.is_shard() and p.dim != last else Replicate()
               for p in x.placements)
    if _local.is_dtensor(w):
        w = _local.to_local(w, (Replicate(),) * len(xp), grad_placements=[
            Partial() if p.is_shard() else Replicate() for p in xp])
    y = fn(_local.to_local(x, xp), w, eps, scale_offset)
    return _local.from_local(y, x, xp)


def rmsnorm(x, w, *, eps: float = 1e-6, scale_offset: bool = False,
            impl: str = "auto"):
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "cuda":
        fn = _kernel
    elif impl == "ref":
        fn = lambda x, w, eps, scale_offset: _ref.rmsnorm(
            x, w, eps=eps, scale_offset=scale_offset)
    else:
        raise ValueError(f"unknown rmsnorm impl {impl!r}")
    if _local.is_dtensor(x):
        return _on_shards(fn, x, w, eps, scale_offset)
    return fn(x, w, eps, scale_offset)
