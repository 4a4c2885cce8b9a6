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
that split the rows).  Where the last dim is split across ranks, the
split stays (:class:`SplitRMSNorm`): each rank sums its columns' squares
(the kernel's ``rmsnorm_sums`` or the plain version's), one all-gather a
split mesh dim brings every rank's partials, their sum is each row's
total, and each rank normalises its columns by it (``w``
sliced to them).  The backward does the same with the sums of x**2 and
of (w' dy) x, and each rank's ``dw`` is its columns'.
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


def _total(part, mesh, split):
    """Partial row sums -> the rows' totals: one all-gather a split mesh
    dim, summed."""
    for i in split:
        part = _local.gather_ranks(part, mesh, i).sum(0)
    return part


class SplitRMSNorm(torch.autograd.Function):
    """RMSNorm of a rank's columns of rows split across the ranks of
    ``split`` (mesh dims): ``impl``, the kernel module or the plain one
    (the same functions and keywords), gives the local halves, and the
    rows' sums cross ranks by one all-gather a mesh dim (forward: x**2;
    backward: x**2 and (w' dy) x)."""

    @staticmethod
    def forward(ctx, x, w, eps, scale_offset, d_norm, mesh, split, impl):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.args = eps, scale_offset, d_norm, mesh, split, impl
        ss = _total(impl.rmsnorm_sums(x, scale_offset=scale_offset), mesh,
                    split)
        return impl.rmsnorm(x, w, eps=eps, scale_offset=scale_offset,
                            ss=ss, d_norm=d_norm)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        eps, scale_offset, d_norm, mesh, split, impl = ctx.args
        dy = dy.contiguous()
        sums = _total(impl.rmsnorm_sums(x, w, dy, scale_offset=scale_offset),
                      mesh, split)
        dx, dw = impl.rmsnorm_bwd(x, w, dy, eps=eps,
                                  scale_offset=scale_offset, sums=sums,
                                  d_norm=d_norm)
        return dx, dw, None, None, None, None, None, None


def _on_shards(fn, x, w, eps, scale_offset, impl):
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    split = _local.split_mesh_dims(x, last)
    if split:
        xp = tuple(p if p.is_shard() else Replicate() for p in x.placements)
        # w's columns where x's are split; its gradient there is the
        # rank's columns, a partial sum where x's rows are split
        wp = tuple(Shard(0) if i in split else Replicate()
                   for i in range(len(xp)))
        wg = tuple(Shard(0) if i in split else
                   Partial() if p.is_shard() else Replicate()
                   for i, p in enumerate(xp))
        xl = _local.to_local(x, xp)
        if _local.is_dtensor(w):
            wl = _local.to_local(w, wp, grad_placements=wg)
        else:
            lo = _local.offset(x, last, xp)
            wl = w[lo:lo + xl.shape[-1]]
        y = SplitRMSNorm.apply(xl, wl, eps, scale_offset, x.shape[-1],
                               x.device_mesh, split, impl)
        return _local.from_local(y, x, xp, x.shape)
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
        from repro_torch.kernels.rmsnorm import kernel as mod
        fn = _kernel
    elif impl == "ref":
        mod = _ref
        fn = lambda x, w, eps, scale_offset: _ref.rmsnorm(
            x, w, eps=eps, scale_offset=scale_offset)
    else:
        raise ValueError(f"unknown rmsnorm impl {impl!r}")
    if _local.is_dtensor(x):
        return _on_shards(fn, x, w, eps, scale_offset, mod)
    return fn(x, w, eps, scale_offset)
