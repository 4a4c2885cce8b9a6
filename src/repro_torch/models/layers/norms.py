"""RMSNorm, optionally Gemma-style ``(1 + w)`` scaling (port of
``repro.models.layers.norms``): computed in f32, cast back to the
input's dtype, as in the JAX package."""
from __future__ import annotations

import torch

from repro_torch.models import init_utils as iu


def init(gen, d: int, *, scale_offset: bool = False):
    dev = gen.device if gen is not None else None
    if scale_offset:  # gemma stores w and applies (1 + w)
        return iu.split_tree({"scale": iu.zeros((d,), (None,), device=dev)})
    return iu.split_tree({"scale": iu.ones((d,), (None,), device=dev)})


def apply(params, x, *, eps: float = 1e-6, scale_offset: bool = False):
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = params["scale"].to(torch.float32)
    w = (1.0 + w) if scale_offset else w
    return (xf * w).to(dt)
