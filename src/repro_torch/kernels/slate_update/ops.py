"""Dispatching wrapper for the fused slate update.

``impl``:
  - "auto": the CUDA kernel for a CUDA table, the plain version for a
    CPU table
  - "cuda": the kernel (raises for a CPU table)
  - "ref":  the plain PyTorch version, on any device
"""
from __future__ import annotations

from repro_torch.kernels.slate_update import ref as _ref


def slate_update(keys_sorted, deltas, slots, table_vals, *,
                 impl: str = "auto", op: str = "sum"):
    """Updates ``table_vals`` in place and returns it."""
    if impl == "auto":
        impl = "cuda" if table_vals.is_cuda else "ref"
    if impl == "cuda":
        from repro_torch.kernels.slate_update import kernel as _k
        return _k.slate_update(keys_sorted, deltas, slots, table_vals, op=op)
    if impl != "ref":
        raise ValueError(f"unknown slate_update impl {impl!r}")
    return _ref.slate_update(keys_sorted, deltas, slots, table_vals, op=op)
