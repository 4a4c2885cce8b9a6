"""Plain PyTorch version of the latency-histogram update (the CPU path
and the kernel's oracle), and of its fused route: the age bucketing of
``telemetry.latency`` composed with the update."""
from __future__ import annotations

import torch

from repro_torch.kernels.countmin import ref as _cm_ref


def histogram_update(counts, cols, add):
    """counts: [rows, width] int32, updated in place and returned; cols:
    [rows, B] int32 bucket per row; add: [B] int32.  Every (row, bucket)
    of an event with ``add > 0`` gains one.  The same function as the
    count-min update (the JAX package keeps two copies of it)."""
    return _cm_ref.countmin_update(counts, cols, add)


def ages(tick, ts: torch.Tensor) -> torch.Tensor:
    """[B] int32 event ages ``max(tick - ts, 0)``: the difference in
    torch's promotion (int32 against an int32 or 0-d tick), wrapping."""
    return torch.clamp(tick - ts, min=0).to(torch.int32)


def bucketize(lat: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """[B] int32 latencies -> [B] int32 bucket indices: 0 -> 0, 1 -> 1,
    [2,4) -> 2, ... [2^(b-1), 2^b) -> b, clamped to the top bucket.

    The JAX package takes ``32 - clz(lat)``; torch has no clz, so the
    bit-length is the count of powers of two ``2^0 .. 2^30`` at or below
    ``lat`` (``searchsorted``), exact for every int32 — float ``log2``
    would misplace ``2^k - 1`` above 2^24."""
    lat = torch.clamp(lat, min=0).to(torch.int32)
    pow2 = torch.bitwise_left_shift(
        torch.ones(31, dtype=torch.int32, device=lat.device),
        torch.arange(31, dtype=torch.int32, device=lat.device))
    b = torch.searchsorted(pow2, lat, right=True)
    return torch.clamp(b, max=n_buckets - 1).to(torch.int32)


def histogram_update_ages(counts, tick, ts, add, *, n_buckets: int,
                          lat_sum):
    """The fused route's function: ``histogram_update(counts,
    bucketize(ages(tick, ts), n_buckets)[None, :], add)``, and ``lat_sum
    += sum of the counted ages`` in place on the 0-d int32 ``lat_sum``
    (wrapping, as the JAX package's int32 sum)."""
    lat = ages(tick, ts)
    histogram_update(counts, bucketize(lat, n_buckets)[None, :], add)
    lat_sum.add_(torch.where(add > 0, lat, 0).sum(dtype=torch.int32))
    return counts
