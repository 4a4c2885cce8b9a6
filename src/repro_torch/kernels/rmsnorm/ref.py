"""Plain PyTorch version of RMSNorm: the CPU path and the ``rmsnorm``
kernel's oracle (port of ``repro/kernels/rmsnorm/ref.py``, the same math
as ``repro/models/layers/norms.py::apply``).

In f32: the mean of squares over the last dimension, ``x * rsqrt(var +
eps)``, then times ``w`` or ``(1 + w)``, cast back to x's dtype.
"""
from __future__ import annotations

import torch


def rmsnorm(x, w, *, eps: float = 1e-6, scale_offset: bool = False):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    wf = w.to(torch.float32)
    wf = (1.0 + wf) if scale_offset else wf
    return (xf * wf).to(x.dtype)


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-6, scale_offset: bool = False):
    """The plain backward, the ``rmsnorm_bwd`` kernel's oracle: autograd
    of :func:`rmsnorm`.  Returns ``(dx, dw)`` in x's and w's dtypes."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        wg = w.detach().requires_grad_(True)
        y = rmsnorm(xg, wg, eps=eps, scale_offset=scale_offset)
        return torch.autograd.grad(y, (xg, wg), dy)
