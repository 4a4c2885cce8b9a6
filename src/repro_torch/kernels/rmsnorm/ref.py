"""Plain PyTorch version of RMSNorm: the CPU path and the ``rmsnorm``
kernel's oracle (port of ``repro/kernels/rmsnorm/ref.py``, the same math
as ``repro/models/layers/norms.py::apply``).

In f32: the mean of squares over the last dimension, ``x * rsqrt(var +
eps)``, then times ``w`` or ``(1 + w)``, cast back to x's dtype.
"""
from __future__ import annotations

import torch


def rmsnorm(x, w, *, eps: float = 1e-6, scale_offset: bool = False,
            ss=None, d_norm: int = None):
    """With ``ss`` ([...] f32, each row's sum of squares over a whole row
    of ``d_norm`` elements, of which x holds the last dim's columns: the
    kernel's keywords) it normalises by that in place of its own mean."""
    xf = x.to(torch.float32)
    if ss is None:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    else:
        var = ss[..., None] / d_norm
    xf = xf * torch.rsqrt(var + eps)
    wf = w.to(torch.float32)
    wf = (1.0 + wf) if scale_offset else wf
    return (xf * wf).to(x.dtype)


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-6, scale_offset: bool = False,
                sums=None, d_norm: int = None):
    """The plain backward, the ``rmsnorm_bwd`` kernel's oracle: autograd
    of :func:`rmsnorm`.  Returns ``(dx, dw)`` in x's and w's dtypes.

    With ``sums`` (:func:`rmsnorm_sums` with ``dy``, ``[..., 2]`` f32,
    over a whole row of ``d_norm`` elements of which x holds some
    columns) the same in closed form over these columns: ``dx = rstd (w'
    dy) - x rstd**3 dot / d_norm``, ``dw = sum_rows dy x rstd``."""
    if sums is None:
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            wg = w.detach().requires_grad_(True)
            y = rmsnorm(xg, wg, eps=eps, scale_offset=scale_offset)
            return torch.autograd.grad(y, (xg, wg), dy)
    f32 = torch.float32
    xf, gy = x.to(f32), dy.to(f32)
    wf = w.to(f32)
    wf = (1.0 + wf) if scale_offset else wf
    rstd = torch.rsqrt(sums[..., :1] / d_norm + eps)
    c = rstd ** 3 * (sums[..., 1:] / d_norm)
    dx = rstd * (gy * wf) - xf * c
    dw = (gy * xf * rstd).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rmsnorm_sums(x, w=None, dy=None, *, scale_offset: bool = False):
    """Each row's f32 partial sums over x's columns (the local half of
    the route over a row split across ranks): ``[...]``, the sum of
    squares; with ``dy`` and ``w``, ``[..., 2]``: it and ``sum (dy w')
    x``."""
    xf = x.to(torch.float32)
    ss = torch.sum(torch.square(xf), dim=-1)
    if dy is None:
        return ss
    wf = w.to(torch.float32)
    wf = (1.0 + wf) if scale_offset else wf
    dot = torch.sum(dy.to(torch.float32) * wf * xf, dim=-1)
    return torch.stack([ss, dot], dim=-1)
