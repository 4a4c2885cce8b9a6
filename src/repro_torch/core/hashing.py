"""Integer hashing (the hashing half of ``repro.core.hashing``).

The JAX package hashes in uint32.  PyTorch has no uint32 ``>>``, ``%``
or ``+`` on the CPU, so the port carries uint32 values in int64 tensors
and masks with ``0xFFFFFFFF`` after every step.  Each 32-bit multiply is
split into 16-bit halves so no intermediate passes 2**48: the low 32
bits come out exactly as uint32 arithmetic gives them, with no reliance
on int64 wrap-around.  Results are int64 tensors holding values in
``[0, 2**32)``, bitwise equal to the JAX package's uint32 hashes.

The consistent-hash ring (``HashRing``, ``route``) belongs to the
multi-shard slice and is not ported here.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, without any product above 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche over uint32 values held in int64."""
    x = x.to(torch.int64) & M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def fold_u32(key: torch.Tensor) -> torch.Tensor:
    """Fold a key tensor to uint32 (in int64): xor-fold for 64-bit keys,
    the identity bit pattern for 32-bit keys.  int64 ``>>`` is an
    arithmetic shift, so the high word is masked after the shift."""
    k = key.to(torch.int64)
    if key.element_size() > 4:
        return (k ^ ((k >> 32) & M32)) & M32
    return k & M32


def hash_key(key: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Hash integer keys (+salt) to uint32 values (int64 tensor)."""
    return mix32(fold_u32(key) ^ (salt & M32))


def fold_u32_np(x: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`fold_u32` (numpy uint32)."""
    if x.dtype.itemsize > 4:
        u = x.astype(np.uint64)
        return (u ^ (u >> np.uint64(32))).astype(np.uint32)
    return x.astype(np.uint32)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return x
