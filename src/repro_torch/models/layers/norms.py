"""RMSNorm, optionally Gemma-style ``(1 + w)`` scaling (port of
``repro.models.layers.norms``): computed in f32, cast back to the
input's dtype, as in the JAX package.  ``apply`` runs through
``kernels/rmsnorm`` (the ``rmsnorm`` kernel on the card, its plain
version, which is the JAX package's math, on the CPU)."""
from __future__ import annotations

from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import init_utils as iu


def init(gen, d: int, *, scale_offset: bool = False):
    dev = gen.device if gen is not None else None
    if scale_offset:  # gemma stores w and applies (1 + w)
        return iu.split_tree({"scale": iu.zeros((d,), (None,), device=dev)})
    return iu.split_tree({"scale": iu.ones((d,), (None,), device=dev)})


def apply(params, x, *, eps: float = 1e-6, scale_offset: bool = False):
    return rms_ops.rmsnorm(x, params["scale"], eps=eps,
                           scale_offset=scale_offset)
