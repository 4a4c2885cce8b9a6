"""Per-arc latency histograms: device state + host readout (port of
``repro.telemetry.latency``).

One power-of-two-bucket histogram per updater arc, updated inside the
tick from ``engine_tick - event.ts`` (``kernels/histogram``).  Bucket
``b`` holds latencies in ``[2^(b-1), 2^b)`` (bucket 0 is exactly {0});
the binning is the integer bit-length, so bucket edges are exact, and
the top bucket saturates.  ``quantile`` interpolates percentiles on the
host from windowed bucket counts.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.histogram import histogram_update_ages
# the plain bucketing, kept here under its JAX package name
from repro_torch.kernels.histogram.ref import bucketize  # noqa: F401

# Logical power-of-two buckets; 32 covers the full int32 latency range.
# The device row keeps the JAX package's width (padded to 128) so state
# carries across; the padded tail is never hit.
N_BUCKETS = 32
LANE = 128


def pad_width(n_buckets: int) -> int:
    """Device row width: logical buckets padded to a multiple of 128."""
    return ((max(1, n_buckets) + LANE - 1) // LANE) * LANE


def make_hist(arcs: Sequence[str], n_buckets: int,
              device=None) -> Dict[str, Any]:
    """Fresh histogram state, one row per updater arc.  ``sum`` is the
    total latency in ticks (int32) for the Prometheus ``_sum`` series."""
    dev = resolve_device(device)
    w = pad_width(n_buckets)
    return {a: {"counts": torch.zeros((1, w), dtype=torch.int32,
                                      device=dev),
                "sum": torch.zeros((), dtype=torch.int32, device=dev)}
            for a in arcs}


def hist_update(h, tick, ts, valid, *, n_buckets: int, impl: str = "auto"):
    """Fold one dequeued batch into one arc's histogram inside the tick:
    fixed shapes, no host sync; ``counts`` and the int32 ``sum`` are
    updated in place (the tick state is, and window reads copy it).
    ``tick - ts`` is the event's age at dequeue, clamped at 0; on the card
    one kernel buckets the ages and sums them (``tick`` read on the
    device)."""
    histogram_update_ages(h["counts"], tick, ts, valid.to(torch.int32),
                          n_buckets=n_buckets, lat_sum=h["sum"], impl=impl)
    return {"counts": h["counts"], "sum": h["sum"]}


# ---- host-side readout (window-boundary snapshots) -------------------

def bucket_lo(b: int) -> int:
    """Inclusive lower edge of bucket b (in ticks)."""
    return 0 if b <= 0 else 1 << (b - 1)


def bucket_hi(b: int) -> int:
    """Exclusive upper edge of bucket b (in ticks)."""
    return 1 << b


def quantile(counts: np.ndarray, q: float, *, n_buckets: int) -> float:
    """Interpolated quantile from (windowed) bucket counts: find the
    bucket holding rank ``q * N`` and place the quantile linearly in its
    ``[lo, hi)``.  Mass in the saturating top bucket reports that
    bucket's lower edge (Prometheus' +Inf convention)."""
    counts = np.asarray(counts, np.float64).ravel()[:n_buckets]
    total = counts.sum()
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for b, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            if b >= n_buckets - 1:
                return float(bucket_lo(b))
            lo, hi = bucket_lo(b), bucket_hi(b)
            frac = min(1.0, max(0.0, (target - cum) / c))
            return float(lo + (hi - lo) * frac)
        cum += c
    return float(bucket_lo(n_buckets - 1))


def quantiles(counts: np.ndarray, qs: Sequence[float], *,
              n_buckets: int):
    return [quantile(counts, q, n_buckets=n_buckets) for q in qs]
