"""Plain PyTorch version of the batched slate point-lookup (the CPU path
and the kernel's oracle, one function a route).

The read-side twin of ``slate_update``'s oracle: walk the probe chain of
every query key over the open-addressing table and gather the hit rows.
The probe math and the insert walk come from ``slates.table`` (looked up
there at call time), so there is one copy of the double-hashing
sequence in the port's torch code.
"""
from __future__ import annotations

import torch

from repro_torch.core.event import tree_map
from repro_torch.slates import table as _tbl


def lookup_cand(table_keys, query, cand):
    """Probe walk over given candidates ``cand`` ([P, Q]).  Returns
    ``(slot [Q], found [Q])``, ``slot`` of ``cand``'s dtype: the first
    candidate holding the key, or -1."""
    hit = table_keys[cand] == query[None]
    found = hit.any(dim=0)
    idx = torch.argmax(hit.to(torch.uint8), dim=0)
    slot = torch.where(found, torch.gather(cand, 0, idx[None])[0], -1)
    return slot, found


def lookup_slots(table_keys, query, capacity=None):
    """``table_keys``: [N] (EMPTY = -1 = free); ``query``: [Q].  Returns
    ``(slot [Q] int64, found [Q])`` over the hashed probe chain.
    ``capacity`` (default N) is the hashed capacity; the engine's tables
    carry one sink row past it."""
    C = int(table_keys.shape[0]) if capacity is None else capacity
    return lookup_cand(table_keys, query, _tbl._probe_seq(query, C))


def gather_rows(vals, slot, found):
    """Gather one pytree of [N, ...] value leaves at ``slot`` ([Q]);
    missing keys ([Q] ``~found``) read as zeros."""
    safe = slot.clamp(min=0)

    def pick(v):
        rows = v[safe]
        mask = found.reshape(found.shape + (1,) * (rows.ndim - 1))
        return torch.where(mask, rows, torch.zeros_like(rows))

    return tree_map(pick, vals)


def slate_lookup(table_keys, query, cand, table_vals):
    """The ``cand`` route on the kernel's inputs: probe walk over
    ``cand`` ([P, Q]) + row gather from ``table_vals`` ([N, D]).
    Returns ``(slot [Q], found [Q], rows [Q, D])``."""
    slot, found = lookup_cand(table_keys, query, cand)
    return slot, found, gather_rows(table_vals, slot, found)


def slate_lookup_keys(table_keys, query, table_vals=None, capacity=None):
    """The ``keys`` route: the probe chain hashed (int32 candidates, the
    kernel's index width and the JAX package's), then as
    :func:`slate_lookup`.  Returns ``(slot [Q] int32, found [Q], rows
    [Q, D] or None)``."""
    C = int(table_keys.shape[0]) if capacity is None else capacity
    cand = _tbl._probe_seq(query, C).to(torch.int32)
    slot, found = lookup_cand(table_keys, query, cand)
    rows = None if table_vals is None else gather_rows(table_vals, slot,
                                                       found)
    return slot, found, rows


def find_slots(table_keys, query, pending, capacity=None):
    """The ``find`` route: ``slates.table._lookup_keys`` over the hashed
    chain, masked by ``pending``.  Returns ``(slot [Q] int64, found
    [Q])``, (-1, False) on rows not pending."""
    C = int(table_keys.shape[0]) if capacity is None else capacity
    return _tbl._lookup_keys(table_keys, query, _tbl._probe_seq(query, C),
                             pending)
