"""CUDA wrapper for the latency-histogram update (``csrc/countmin.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/histogram/kernel.py::
histogram_update``: fold a batch of latency bucket indices into the
``[rows, width]`` histogram in place.  It is the count-min kernel's
function (the TPU package keeps two copies), so it launches the same
CUDA kernel; see ``kernels/countmin/kernel.py`` for its bound and
design.  On the engine's path every event of a tick tends to share one
or two buckets, which the kernel's per-warp grouping of equal columns
turns into one shared-memory atomic per warp.

Two routes: ``histogram_update`` takes the bucket columns (``cols``, the
TPU kernel's interface), and ``histogram_update_ages`` takes the tick
and the event times, buckets each age in the kernel and can add the
counted ages into the arc's int32 latency sum (``ages``, the telemetry
path's route: it saves the launches of the bucketing and of the sum).
Both count in ``histogram_update.launches`` and, by route, in
``histogram_update.launches_by_route``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.countmin import kernel as _cm

I32 = (-2**31, 2**31 - 1)


def _count(route: str) -> None:
    histogram_update.launches += 1
    histogram_update.launches_by_route[route] += 1


def histogram_update(counts: torch.Tensor, cols: torch.Tensor,
                     add: torch.Tensor) -> torch.Tensor:
    """counts: [rows, width] int32, updated in place and returned; cols:
    [rows, B] int32 buckets; add: [B] int32 (an event counts where > 0)."""
    if _cm.launch(counts, cols, add, "histogram_update"):
        _count("cols")
    return counts


def histogram_update_ages(counts: torch.Tensor, tick, ts: torch.Tensor,
                          add: torch.Tensor, *, n_buckets: int,
                          lat_sum: torch.Tensor) -> torch.Tensor:
    """One histogram row of event ages, bucketed in the kernel: counts
    [1, width] int32 with width >= n_buckets, updated in place and
    returned; tick: a 0-d int32 tensor on the card (read there, no host
    sync) or a Python int; ts: [B] int32; add: [B] int32.  Event i counts
    in bucket ``min(bit_length(max(tick - ts[i], 0)), n_buckets - 1)``,
    the int32 difference wrapping as in torch.  ``lat_sum``: a 0-d int32
    tensor on the card that gains the counted events' ages in place
    (mod 2**32, as torch's int32 sum)."""
    who = "histogram_update_ages"
    ins = (("lat_sum", lat_sum), ("ts", ts), ("add", add))
    if isinstance(tick, torch.Tensor):
        ins = (("tick", tick),) + ins
    if any(t.ndim != 0 for _, t in ins[:-2]):
        raise ValueError(f"{who} kernel: tick and lat_sum must be 0-d")
    B = _cm.check_args(counts, ins, who)
    width = counts.shape[1]
    if counts.shape[0] != 1 or ts.ndim != 1 or add.ndim != 1 \
            or not 1 <= n_buckets <= width:
        raise ValueError(f"{who} kernel: counts must be [1, width], ts and "
                         f"add [B], 1 <= n_buckets <= width")
    if isinstance(tick, torch.Tensor):
        tick_ptr, tick_val = tick.data_ptr(), 0
    else:
        if not I32[0] <= int(tick) <= I32[1]:
            raise ValueError(f"{who} kernel: tick {tick} is not an int32")
        tick_ptr, tick_val = None, int(tick)
    if B == 0:
        return counts
    lib = _cm._lib()
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    code = lib.countmin_ages_launch(
        counts.data_ptr(), ts.data_ptr(), add.data_ptr(), tick_ptr,
        tick_val, n_buckets, lat_sum.data_ptr(), width, B, stream)
    _build.check(lib, _cm._NAME, code)
    _count("ages")
    return counts


histogram_update.launches = 0
histogram_update.launches_by_route = {"cols": 0, "ages": 0}
