"""Dispatching wrappers for the count-min sketch update.

``impl``:
  - "auto": the CUDA kernel for a CUDA sketch, the plain version for a
    CPU sketch
  - "cuda": the kernel (raises for a CPU sketch)
  - "ref" / "jnp": the plain PyTorch version ("jnp" keeps the JAX
    package's name for it)

``countmin_update`` takes hashed columns (the TPU kernel's interface);
``countmin_update_keys`` takes the keys and salts, and its kernel hashes
the columns itself.  Both are exact integer adds, so kernel and plain
version agree bitwise.
"""
from __future__ import annotations

from repro_torch.kernels.countmin import ref as _ref


def _pick(impl, counts):
    if impl == "auto":
        impl = "cuda" if counts.is_cuda else "ref"
    if impl not in ("cuda", "ref", "jnp"):
        raise ValueError(f"unknown countmin impl {impl!r}")
    return impl


def countmin_update(counts, cols, add, *, impl: str = "auto"):
    """Updates ``counts`` in place and returns it."""
    if _pick(impl, counts) == "cuda":
        from repro_torch.kernels.countmin import kernel as _k
        return _k.countmin_update(counts, cols, add)
    return _ref.countmin_update(counts, cols, add)


def countmin_update_keys(counts, keys, add, salts, *, impl: str = "auto"):
    """Updates ``counts`` in place with the columns of ``keys`` under the
    host ``salts`` (numpy uint32) and returns it."""
    if _pick(impl, counts) == "cuda":
        from repro_torch.kernels.countmin import kernel as _k
        return _k.countmin_update_keys(counts, keys, add, salts)
    return _ref.countmin_update_keys(counts, keys, add, salts)
