"""Dispatching wrapper for the count-min sketch update.

``impl``:
  - "auto": the CUDA kernel for a CUDA sketch, the plain version for a
    CPU sketch
  - "cuda": the kernel (raises for a CPU sketch)
  - "ref" / "jnp": the plain PyTorch version ("jnp" keeps the JAX
    package's name for it)

Both are exact integer adds, so they agree bitwise.
"""
from __future__ import annotations

from repro_torch.kernels.countmin import ref as _ref


def countmin_update(counts, cols, add, *, impl: str = "auto"):
    """Updates ``counts`` in place and returns it."""
    if impl == "auto":
        impl = "cuda" if counts.is_cuda else "ref"
    if impl == "cuda":
        from repro_torch.kernels.countmin import kernel as _k
        return _k.countmin_update(counts, cols, add)
    if impl not in ("ref", "jnp"):
        raise ValueError(f"unknown countmin impl {impl!r}")
    return _ref.countmin_update(counts, cols, add)
