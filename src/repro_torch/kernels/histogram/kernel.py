"""CUDA wrapper for the latency-histogram update (``csrc/countmin.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/histogram/kernel.py::
histogram_update``: fold a batch of latency bucket indices into the
``[rows, width]`` histogram in place.  It is the count-min kernel's
function (the TPU package keeps two copies), so it launches the same
CUDA kernel; see ``kernels/countmin/kernel.py`` for its bound and
design.  On the engine's path every event of a tick tends to share one
or two buckets, which the kernel's per-warp grouping of equal columns
turns into one shared-memory atomic per warp.

Counts its own launches in ``histogram_update.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.countmin.kernel import launch


def histogram_update(counts: torch.Tensor, cols: torch.Tensor,
                     add: torch.Tensor) -> torch.Tensor:
    """counts: [rows, width] int32, updated in place and returned; cols:
    [rows, B] int32 buckets; add: [B] int32 (an event counts where > 0)."""
    if launch(counts, cols, add, "histogram_update"):
        histogram_update.launches += 1
    return counts


histogram_update.launches = 0
