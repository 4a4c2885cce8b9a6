"""Plain PyTorch version of the count-min sketch update (the CPU path and
the kernel's oracle)."""
from __future__ import annotations

import torch


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
