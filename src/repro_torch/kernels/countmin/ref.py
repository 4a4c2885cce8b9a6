"""Plain PyTorch version of the count-min sketch update (the CPU path and
the kernel's oracle), and of its fused route: the column hash of
``telemetry.sketch`` composed with the update."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import fold_u32, mix32

_salts_on: Dict[Tuple[torch.device, bytes], torch.Tensor] = {}


def countmin_update(counts, cols, add):
    """counts: [depth, width] int32, updated in place and returned; cols:
    [depth, B] int32 column per row; add: [B] int32.  Every (row, col) of
    an event with ``add > 0`` gains one; duplicate columns accumulate.

    The TPU kernel counts one per event with ``add > 0`` (masked events
    go to a sink column); the JAX package's oracle scatter-adds ``add``
    as it is.  The two agree for the 0/1 ``add`` the engine passes, and
    so does this version, which follows the kernel.  One flat scatter
    over the ravelled sketch, as in the JAX oracle."""
    depth, width = counts.shape
    flat = cols.to(torch.int64) + (
        torch.arange(depth, dtype=torch.int64, device=cols.device)
        * width)[:, None]
    amt = (add > 0).to(counts.dtype)[None, :].expand(cols.shape)
    counts.view(-1).index_add_(0, flat.reshape(-1), amt.reshape(-1))
    return counts


def salts_tensor(salts: np.ndarray, device) -> torch.Tensor:
    """Salts as the int64 tensor ``columns`` takes (uint32 values), made
    once per device and salts and then reused: a host-to-device copy
    inside the tick would sync the host."""
    s = np.asarray(salts, np.int64)
    key = (torch.device(device), s.tobytes())
    t = _salts_on.get(key)
    if t is None:
        t = _salts_on[key] = torch.as_tensor(s, device=device)
    return t


def columns(keys: torch.Tensor, salts, width: int) -> torch.Tensor:
    """[B] integer keys -> [depth, B] int32 hashed columns
    ``mix32(fold_u32(key) ^ salt) % width``, bitwise the JAX package's
    (64-bit keys enter through the same xor-fold).  ``salts``: numpy
    uint32 or the tensor of :func:`salts_tensor`."""
    s = salts if isinstance(salts, torch.Tensor) \
        else salts_tensor(salts, keys.device)
    h = mix32(fold_u32(keys)[None, :] ^ s[:, None])
    return (h % width).to(torch.int32)


def countmin_update_keys(counts, keys, add, salts):
    """The fused route's function: ``countmin_update(counts,
    columns(keys, salts, width), add)``."""
    return countmin_update(counts, columns(keys, salts, counts.shape[1]),
                           add)
