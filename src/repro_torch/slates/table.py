"""Device-resident slate table: a fixed-capacity open-addressing hash map
(port of ``repro.slates.table``).

One table per updater holds its slates — the "slate cache in the memory
of the machine running U" of paper section 4.2 — as struct-of-arrays on
the card, so the updater hot loop is gather / compute / scatter.
Collisions use double hashing with a static probe budget; batch inserts
resolve intra-batch slot races over bounded retry rounds.  Keys that
cannot be placed are dropped and counted.

Storage differs from the JAX package in one way: every ``[C]``-leading
tensor carries one extra row at index ``C``, a sink for masked scatters.
JAX writes out-of-bounds indices with ``mode="drop"``; torch has no drop
mode, and boolean-mask indexing would sync the host on CUDA.  Masked
rows are redirected to the sink instead, so every op stays fixed-shape.
No lookup ever lands on the sink (probe slots are ``< C``);
``capacity`` excludes it and ``convert.state_to_numpy`` strips it.

The table is updated in place (the JAX engine donates it instead); the
functions still return it so callers read as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch._device import resolve_device, torch_dtype
from repro_torch.core.event import register_dataclass, tree_map
from repro_torch.core.hashing import M32, hash_key

EMPTY = -1
PROBES = 8          # static probe budget per lookup
INSERT_ROUNDS = 4   # bounded retry rounds for batch insert


@register_dataclass
@dataclass
class SlateTable:
    keys: torch.Tensor     # int32/int64 [C+1], EMPTY = free, [C] = sink
    ts: torch.Tensor       # int32 [C+1] last-update tick (TTL)
    dirty: torch.Tensor    # bool [C+1] updated since last flush
    vals: Any              # pytree, leaves [C+1, ...]
    dropped: torch.Tensor  # int32 [] lifetime insert-failure count

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[-1]) - 1

    def occupancy(self) -> torch.Tensor:
        """Slots in use: a 0-d count, or ``[S]`` counts for a table
        stacked over shards (``DistributedEngine``)."""
        return (self.keys[..., :-1] != EMPTY).sum(dim=-1, dtype=torch.int32)


def make_table(capacity: int, value_spec: Dict[str, Any],
               key_dtype=torch.int32, device=None) -> SlateTable:
    """value_spec: pytree of (shape_suffix, dtype)."""
    dev = resolve_device(device)
    n = capacity + 1
    vals = tree_map(
        lambda s: torch.zeros((n,) + tuple(s[0]), dtype=torch_dtype(s[1]),
                              device=dev),
        value_spec, is_leaf=_is_spec_leaf)
    return SlateTable(
        keys=torch.full((n,), EMPTY, dtype=torch_dtype(key_dtype), device=dev),
        ts=torch.zeros(n, dtype=torch.int32, device=dev),
        dirty=torch.zeros(n, dtype=torch.bool, device=dev),
        vals=vals,
        dropped=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _is_spec_leaf(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def _probe_seq(query: torch.Tensor, capacity: int) -> torch.Tensor:
    """[P, B] int64 candidate slots (double hashing), bitwise the JAX
    package's uint32 sequence."""
    h1 = hash_key(query, salt=0xA11CE) % capacity
    h2 = hash_key(query, salt=0xB0B) % (capacity - 1) + 1
    steps = torch.arange(PROBES, dtype=torch.int64,
                         device=query.device)[:, None]
    # uint32 wrap of h1 + step * h2, then the modulus
    return ((h1[None] + steps * h2[None]) & M32) % capacity


def _first_true(mask: torch.Tensor, vals: torch.Tensor, default: int):
    """Along axis 0: the entry of ``vals`` at the first True of ``mask``
    (``default`` where there is none), and whether there was one.
    ``torch.argmax`` refuses bool; on uint8 it returns the first
    maximal index, as ``jnp.argmax`` does."""
    any_ = mask.any(dim=0)
    idx = torch.argmax(mask.to(torch.uint8), dim=0)
    picked = torch.gather(vals, 0, idx[None])[0]
    return torch.where(any_, picked, default), any_


def lookup(table: SlateTable, query) -> Tuple[torch.Tensor, torch.Tensor]:
    """query: [B] keys -> (slot [B] int64, found [B]).  slot is the
    matching slot if found, else the first empty probe slot (insertion
    point), else -1 (probe budget exhausted)."""
    cand = _probe_seq(query, table.capacity)              # [P,B]
    ck = table.keys[cand]                                 # [P,B]
    hit = ck == query[None]
    free = ck == EMPTY
    hit_slot, found = _first_true(hit, cand, -1)
    free_slot, has_free = _first_true(free, cand, -1)
    slot = torch.where(found, hit_slot,
                       torch.where(has_free, free_slot, -1))
    return slot, found


def insert_or_find(table: SlateTable, query, valid) -> Tuple[
        SlateTable, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Place unique ``query`` keys (masked by ``valid``).

    Returns (table, slot [B], found_existing [B], placed [B]).  New keys
    claim empty slots; intra-batch races on the same empty slot resolve
    over INSERT_ROUNDS retries; stragglers are dropped (counted).  The
    caller guarantees that valid keys are unique.

    A race on one empty slot goes to the claimant with the highest batch
    row, as the JAX package's last-writer-wins scatter gives it on the
    CPU.  torch's ``index_put_`` with duplicate indices has no defined
    winner on CUDA, so the winner is chosen explicitly: a
    ``scatter_reduce("amax")`` of row indices per slot, then only the
    winners write.  Rows that claim nothing reduce into a private cell
    each (``C + row``), not one shared sink, so the atomics never pile
    onto a single address.  ``table.keys`` is updated in place.

    Each round's walk covers the rows still pending (the others give
    (-1, False), which the round masks out anyway): on a CUDA table one
    launch of the lookup kernel's ``find`` route, which hashes the chain
    itself; on the CPU :func:`_lookup_keys` over a chain hashed once.
    """
    C = table.capacity
    dev = query.device
    keys_arr = table.keys
    B = query.shape[0]
    rows = torch.arange(B, dtype=torch.int64, device=dev)
    rows32 = rows.to(torch.int32)
    slot = torch.full((B,), -1, dtype=torch.int64, device=dev)
    placed = torch.zeros(B, dtype=torch.bool, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    pending = valid
    if keys_arr.is_cuda:
        # imported here: the kernel module imports this one
        from repro_torch.kernels.slate_lookup import kernel as _k
        walk = lambda p: _k.find_slots(keys_arr, query, p, capacity=C)
    else:
        # the probe chain depends on the query alone: hash once, not per
        # round (XLA folds the JAX package's repeats; eager torch would not)
        cand = _probe_seq(query, C)
        walk = lambda p: _lookup_keys(keys_arr, query, cand, p)
    # claim cells, allocated once; each round resets the cells it wrote
    owner = torch.full((C + B,), -1, dtype=torch.int32, device=dev)

    for _ in range(INSERT_ROUNDS):
        cand_slot, cand_found = walk(pending)
        want = pending & (cand_slot >= 0)
        claim = want & ~cand_found
        cell = torch.where(claim, cand_slot, C + rows)
        owner.scatter_reduce_(0, cell, rows32, "amax")
        win = claim & (owner[cell] == rows32)
        owner.index_fill_(0, cell, -1)
        keys_arr.index_put_((torch.where(win, cand_slot, C),),
                            query.to(keys_arr.dtype))
        owner_ok = keys_arr[cand_slot.clamp(0, C - 1)] == query
        success = want & (cand_found | owner_ok)
        slot = torch.where(success, cand_slot, slot)
        found = found | (want & cand_found)
        placed = placed | success
        pending = pending & ~success

    table.dropped = table.dropped + pending.sum(dtype=torch.int32)
    return table, slot, found, placed


def _lookup_keys(keys_arr, query, cand, pending):
    """The insert walk over candidates ``cand`` ([P, B]): on each row
    where ``pending``, the first probe that holds the key or ``EMPTY``
    (slot -1 if none does) and whether it holds the key; (-1, False) on
    the other rows.  The plain version of the lookup kernel's ``find``
    route."""
    ck = keys_arr[cand]
    hit = ck == query[None]
    free = ck == EMPTY
    stop = (hit | free) & pending[None]
    any_ = stop.any(dim=0)
    idx = torch.argmax(stop.to(torch.uint8), dim=0)
    slot = torch.where(any_, torch.gather(cand, 0, idx[None])[0], -1)
    found = torch.gather(hit, 0, idx[None])[0] & any_
    return slot, found


def read_slates(table: SlateTable, slot, found, init_fn: Callable):
    """Gather slate values; missing keys get ``init_fn(batch)`` defaults.
    (Paper: 'the update function must set up and initialize the slate on
    first access'.)"""
    safe = slot.clamp(0, table.capacity - 1)
    gathered = tree_map(lambda v: v[safe], table.vals)
    fresh = init_fn(slot.shape[0], device=slot.device)
    pick = lambda g, f: torch.where(_bshape(found, g), g, f.to(g.dtype))
    return tree_map(pick, gathered, fresh)


def write_slates(table: SlateTable, slot, ok, new_vals, tick) -> SlateTable:
    """Write ``new_vals`` rows at ``slot`` where ``ok`` (in place)."""
    safe = torch.where(ok, slot, table.capacity)
    tree_map(lambda tv, nv: tv.index_put_((safe,), nv.to(tv.dtype)),
             table.vals, new_vals)
    fill_rows(table.ts, safe, tick)
    fill_rows(table.dirty, safe, True)
    return table


def expire_ttl(table: SlateTable, now, ttl: int) -> SlateTable:
    """Garbage-collect slates idle for > ttl ticks (paper section 4.2),
    in place."""
    dead = (table.keys != EMPTY) & (now - table.ts > ttl)
    table.keys.masked_fill_(dead, EMPTY)
    table.dirty.masked_fill_(dead, False)
    return table


def fill_rows(dst: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``dst[idx] = value`` in place, for a Python scalar or a 0-d tensor
    on ``dst``'s device.  Neither form copies from the host or reads the
    value back (``index_fill_`` with a tensor value would call
    ``.item()``, a host sync on CUDA)."""
    if isinstance(value, torch.Tensor):
        return dst.index_put_((idx,), value.to(dst.dtype))
    return dst.index_fill_(0, idx, value)


def _bshape(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))
