"""Dispatching wrapper for the batched slate point-lookup.

``impl``:
  - "auto": the CUDA kernel for a CUDA table, the plain version for a
    CPU table
  - "cuda": the kernel (raises for a CPU table)
  - "jnp" / "ref": the plain PyTorch probe walk ("jnp" keeps the JAX
    package's name for it)

On the card every entry point takes the kernel's ``keys`` route: the
probe chain is hashed in the kernel, so no candidates are built.
"""
from __future__ import annotations

from repro_torch.core.event import flatten_sorted, unflatten_sorted

from repro_torch.kernels.slate_lookup import ref as _ref


def _resolve(impl: str, table) -> str:
    if impl == "auto":
        return "cuda" if table.is_cuda else "ref"
    if impl == "jnp":
        return "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown slate_lookup impl {impl!r}")
    return impl


def lookup_slots(table_keys, query, capacity=None, *, impl: str = "auto"):
    """Probe walk only: ``(slot [Q], found [Q])``.  ``capacity`` (default
    N) is the hashed capacity.  The kernel gives int32 slots, the plain
    version int64."""
    if _resolve(impl, table_keys) == "cuda":
        from repro_torch.kernels.slate_lookup import kernel as _k
        slot, found, _ = _k.slate_lookup_keys(table_keys, query,
                                              capacity=capacity)
        return slot, found
    return _ref.lookup_slots(table_keys, query, capacity)


def slate_lookup(table_keys, query, table_vals, *, impl: str = "auto",
                 capacity=None):
    """Probe walk + row gather over one [N, D] value matrix.  Returns
    ``(slot [Q] int32, found [Q], rows [Q, D])`` with missing rows
    zeroed; bitwise identical across backends.  ``capacity`` (default N)
    is the hashed capacity."""
    if _resolve(impl, table_vals) == "cuda":
        from repro_torch.kernels.slate_lookup import kernel as _k
        return _k.slate_lookup_keys(table_keys, query, table_vals,
                                    capacity=capacity)
    return _ref.slate_lookup_keys(table_keys, query, table_vals, capacity)


def lookup_tree(table_keys, table_vals, query, *, impl: str = "auto",
                capacity=None):
    """Batched lookup over a whole slate-value pytree.  The kernel takes
    the probe walk and the rows of the first [N, D] leaf with 4-byte
    elements; the other leaves, if any, are gathered at the slots it
    found by the plain version.  (The JAX package runs its kernel only
    for a single such leaf and walks the probe chain in jnp otherwise;
    the slots and rows are the same.)  A tree with no such leaf takes the
    probe walk alone.  Returns ``(found [Q], rows)`` with ``rows``
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
    slot, found = lookup_slots(table_keys, query, capacity, impl=impl)
    return found, _ref.gather_rows(table_vals, slot, found)
