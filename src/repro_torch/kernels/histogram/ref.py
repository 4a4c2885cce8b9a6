"""Plain PyTorch version of the latency-histogram update (the CPU path
and the kernel's oracle)."""
from __future__ import annotations

from repro_torch.kernels.countmin import ref as _cm_ref


def histogram_update(counts, cols, add):
    """counts: [rows, width] int32, updated in place and returned; cols:
    [rows, B] int32 bucket per row; add: [B] int32.  Every (row, bucket)
    of an event with ``add > 0`` gains one.  The same function as the
    count-min update (the JAX package keeps two copies of it)."""
    return _cm_ref.countmin_update(counts, cols, add)
