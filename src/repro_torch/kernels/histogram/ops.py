"""Dispatching wrapper for the latency-histogram update.

``impl``: the same vocabulary as ``kernels/countmin``: "auto" (the CUDA
kernel for a CUDA histogram, the plain version for a CPU one), "cuda",
"ref" / "jnp".  Both are exact integer adds, so they agree bitwise.
"""
from __future__ import annotations

from repro_torch.kernels.histogram import ref as _ref


def histogram_update(counts, cols, add, *, impl: str = "auto"):
    """Updates ``counts`` in place and returns it."""
    if impl == "auto":
        impl = "cuda" if counts.is_cuda else "ref"
    if impl == "cuda":
        from repro_torch.kernels.histogram import kernel as _k
        return _k.histogram_update(counts, cols, add)
    if impl not in ("ref", "jnp"):
        raise ValueError(f"unknown histogram impl {impl!r}")
    return _ref.histogram_update(counts, cols, add)
