"""Rotary position embeddings (port of ``repro.models.layers.rope``):
the split-halves (rotate_half) convention of the Llama/Qwen/Gemma HF
implementations, computed in f32 and cast back."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

# inverse frequencies per (head_dim, theta, device): made once, so a
# decode step does not rebuild them in every layer
_INV: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    key = (head_dim, float(theta), torch.device(device))
    inv = _INV.get(key)
    if inv is None:
        half = head_dim // 2
        exponent = torch.arange(half, dtype=torch.float32,
                                device=device) / half
        # an f32 theta, as ``theta ** exponent`` gives in JAX; made by a
        # fill, not a host copy, so a first call inside a tick does not
        # sync
        base = torch.full((), theta, dtype=torch.float32, device=device)
        inv = 1.0 / torch.pow(base, exponent)
        _INV[key] = inv
    return inv  # [half]


def apply_rope(x, positions, *, theta: float = 10_000.0):
    """x: [..., S, H, Dh] (or [..., S, Dh]); positions: broadcastable
    [..., S]."""
    head_dim = x.shape[-1]
    inv = _freqs(head_dim, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv   # [..., S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == ang.ndim + 1:                           # heads axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
