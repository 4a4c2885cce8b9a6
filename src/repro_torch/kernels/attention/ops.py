"""Dispatching wrapper for attention (port of ``repro/kernels/attention/
ops.py``).

``impl``:
  - "auto": the ``flash_attention`` CUDA kernel for a CUDA ``q``, the
    plain version for a CPU ``q``
  - "cuda": the kernel (raises for CPU tensors or a shape it cannot take)
  - "ref": the plain PyTorch version

Where q, k or v needs a gradient, "cuda" runs the kernel inside
:class:`KernelAttention`, whose backward is the ``flash_attention_bwd``
kernel; the plain version is differentiated by autograd.

On DTensors (a mesh) either route runs on each rank's local shards
(``kernels/_local.py``): the batch and head shards q, k and v share are
kept, any other dim is gathered first, and the output is a DTensor in
q's kept placements.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _local
from repro_torch.kernels.attention import ref as _ref


class KernelAttention(torch.autograd.Function):
    """The ``flash_attention`` kernel forward (with its rows'
    log-sum-exp), the ``flash_attention_bwd`` kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        from repro_torch.kernels.flash_attention import kernel as _k
        o, lse = _k.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.flash_attention import kernel as _k
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _k.flash_attention_bwd(q, k, v, o, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None


def _kernel(q, k, v, causal, window, q_offset):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return KernelAttention.apply(q, k, v, causal, window, q_offset)
    from repro_torch.kernels.flash_attention import kernel as _k
    return _k.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)


def mha(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
        chunk: int = 512, impl: str = "auto"):
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "cuda":
        fn = _kernel
    elif impl == "ref":
        fn = lambda q, k, v, causal, window, q_offset: _ref.mha(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            chunk=chunk)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    if _local.is_dtensor(q):
        pls = _local.common_placements((q, k, v), ((0, 2),) * 3)
        o = fn(*(_local.to_local(t, pl) for t, pl in zip((q, k, v), pls)),
               causal, window, q_offset)
        return _local.from_local(o, q, pls[0])
    return fn(q, k, v, causal, window, q_offset)
