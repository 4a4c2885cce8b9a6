"""Dispatching wrapper for the batched slate point-lookup.

``impl``:
  - "auto": the CUDA kernel for a CUDA table, the plain version for a
    CPU table
  - "cuda": the kernel (raises for a CPU table)
  - "jnp" / "ref": the plain PyTorch probe walk ("jnp" keeps the JAX
    package's name for it)
"""
from __future__ import annotations

from repro_torch.core.event import flatten_sorted, unflatten_sorted
import torch

from repro_torch.kernels.slate_lookup import ref as _ref
from repro_torch.slates.table import _probe_seq


def lookup_slots(table_keys, query, capacity=None):
    """Probe walk only: ``(slot [Q], found [Q])``, always the plain
    version — the kernel earns its keep on the row gather."""
    return _ref.lookup_slots(table_keys, query, capacity)


def _resolve(impl: str, table_vals) -> str:
    if impl == "auto":
        return "cuda" if table_vals.is_cuda else "ref"
    if impl == "jnp":
        return "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown slate_lookup impl {impl!r}")
    return impl


def slate_lookup(table_keys, query, table_vals, *, impl: str = "auto",
                 capacity=None):
    """Probe walk + row gather over one [N, D] value matrix.  Returns
    ``(slot [Q] int32, found [Q], rows [Q, D])`` with missing rows
    zeroed; bitwise identical across backends.  ``capacity`` (default N) is the
    hashed capacity."""
    impl = _resolve(impl, table_vals)
    C = int(table_keys.shape[0]) if capacity is None else capacity
    # int32 candidates and slots: the kernel's index width, and the JAX
    # package's
    cand = _probe_seq(query, C).to(torch.int32)
    if impl == "cuda":
        from repro_torch.kernels.slate_lookup import kernel as _k
        return _k.slate_lookup(table_keys, query, cand, table_vals)
    return _ref.slate_lookup(table_keys, query, cand, table_vals)


def lookup_tree(table_keys, table_vals, query, *, impl: str = "auto",
                capacity=None):
    """Batched lookup over a whole slate-value pytree.  The kernel takes
    the probe walk and the rows of the first [N, D] leaf with 4-byte
    elements; the other leaves, if any, are gathered at the slots it
    found by the plain version.  (The JAX package runs its kernel only
    for a single such leaf and walks the probe chain in jnp otherwise;
    the slots and rows are the same.)  A tree with no such leaf takes the
    plain probe walk.  Returns ``(found [Q], rows)`` with ``rows``
    leaves [Q, ...], missing keys zeroed."""
    leaves, treedef = flatten_sorted(table_vals)
    wide = [i for i, v in enumerate(leaves)
            if v.ndim == 2 and v.element_size() == 4]
    if wide:
        slot, found, rows = slate_lookup(table_keys, query, leaves[wide[0]],
                                         impl=impl, capacity=capacity)
        out = [rows if i == wide[0] else _ref.gather_rows(v, slot, found)
               for i, v in enumerate(leaves)]
        return found, unflatten_sorted(treedef, out)
    _resolve(impl, leaves[0])
    slot, found = lookup_slots(table_keys, query, capacity)
    return found, _ref.gather_rows(table_vals, slot, found)
