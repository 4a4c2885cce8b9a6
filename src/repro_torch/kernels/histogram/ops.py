"""Dispatching wrappers for the latency-histogram update.

``impl``: the same vocabulary as ``kernels/countmin``: "auto" (the CUDA
kernel for a CUDA histogram, the plain version for a CPU one), "cuda",
"ref" / "jnp".  ``histogram_update`` takes bucket columns (the TPU
kernel's interface); ``histogram_update_ages`` takes the tick and the
event times, and its kernel buckets the ages itself.  Both are exact
integer adds, so kernel and plain version agree bitwise.
"""
from __future__ import annotations

from repro_torch.kernels.histogram import ref as _ref


def _pick(impl, counts):
    if impl == "auto":
        impl = "cuda" if counts.is_cuda else "ref"
    if impl not in ("cuda", "ref", "jnp"):
        raise ValueError(f"unknown histogram impl {impl!r}")
    return impl


def histogram_update(counts, cols, add, *, impl: str = "auto"):
    """Updates ``counts`` in place and returns it."""
    if _pick(impl, counts) == "cuda":
        from repro_torch.kernels.histogram import kernel as _k
        return _k.histogram_update(counts, cols, add)
    return _ref.histogram_update(counts, cols, add)


def histogram_update_ages(counts, tick, ts, add, *, n_buckets: int,
                          lat_sum, impl: str = "auto"):
    """Updates one histogram row in place with the buckets of the ages
    ``max(tick - ts, 0)``, and ``lat_sum`` with their sum, and returns
    the row."""
    if _pick(impl, counts) == "cuda":
        from repro_torch.kernels.histogram import kernel as _k
        return _k.histogram_update_ages(counts, tick, ts, add,
                                        n_buckets=n_buckets, lat_sum=lat_sum)
    return _ref.histogram_update_ages(counts, tick, ts, add,
                                      n_buckets=n_buckets, lat_sum=lat_sum)
