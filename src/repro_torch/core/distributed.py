"""Multi-shard MapUpdate engine, its shards on one card or over the ranks
of a ``torch.distributed`` process group (port of
``repro.core.distributed``).

Muppet's data path — workers hash events to peers and write directly into
their queues — is one *exchange* per workflow hop: events are routed by
key through the hash ring (``core/hashing.py``) to the shard that owns
the key's slate, bucketed by destination, and delivered.  The JAX
package runs the tick under ``shard_map``, one device a shard, with an
``all_to_all`` in the middle of it.  Here a device holds a block of
shards (all of them on one card) and the tick runs stage by stage over
its block:

- **State layout** is the JAX package's: every per-shard leaf has a
  leading ``n_shards`` dimension (queue buffers ``[S, Q+1]``, tables
  ``[S, C+1]``, counters ``[S]``).  Each stage's per-shard work is one
  loop over shards that calls the single-shard functions
  (``core/apply.py``, ``core/queues.py``, ``slates/table.py``,
  ``telemetry/{sketch,latency}.py``) on views ``x[s]`` of the stacked
  state, so the in-place slate writes land in the stacked tables; the
  small leaves a stage replaces are stacked back once per tick.
- **The exchange** works on the stacked ``[S, B]`` batches of the
  block's shards at once (:func:`exchange`): route, rank each event
  among its row's events for the same destination, scatter into the
  ``[S_dst, S_src * cap]`` bucket layout.  On one card that scatter is
  the whole permutation: shard d receives source shard major, then
  bucket position, as ``all_to_all`` delivers it, and
  ``exchange_dropped`` counts the same overflow.
- **The mesh** has no devices: :func:`make_mesh` gives the axis sizes,
  all the engine reads of one (the shard count and the linear shard
  index, trailing axis fastest), and optionally a process group.
- **Ranks.**  With a group, each rank holds one contiguous block of the
  linear shard index: rank r holds shards ``[r*L, (r+1)*L)``, ``L =
  n_shards / world``, every stacked leaf ``[L, ...]`` on the rank's
  device (the counterpart of the JAX package's one device a shard).
  Each hop's buckets then go through one
  ``torch.distributed.all_to_all_single`` of equal splits (the fields
  packed into one byte buffer), and the received block is reordered to
  the source-shard-major layout above.  Reads, stats, load signals, the
  migration plan and the host tier ``all_gather`` what they need, so
  every rank returns the same answer and takes the same decision.  A
  group is never bypassed, even a group of one (``COLLECTIVES`` counts
  the calls); without a group the engine is a world of one and every
  shard lives on its one device, as before.

A tick issues about S times the single-shard operations plus one
exchange a (stream, subscriber) pair; ``run_chunk`` never reads the
device from the host, and ``run`` drives chunks of ``cfg.chunk_size``
ticks with no host sync between flush and telemetry boundaries.

Two-choice dispatch (Muppet 2.0 dual queues) spills a key's per-tick
load beyond ``two_choice_threshold`` to its secondary shard, and
``split_keys`` (DESIGN.md 13.4) alternates a hot key's events between
its two shards; ``read_slate`` merges the (at most two) partials.
``fail_shard`` re-routes a crashed shard's keys (its unflushed slates
and queued events are lost, the paper's semantics); with durability on,
each shard writes its own WAL and ``recover`` re-routes flushed slates
and replayed events through the current ring.

Live elasticity (DESIGN.md sections 12 and 14): ``scale``,
``add_shards``, ``remove_shards``, ``rebalance``, ``clear_split`` and
``compact`` migrate slates and queued events loss-free at a drain
barrier.  A migration is a permutation of the stacked state: the device
tier (shapes kept) runs :func:`exchange_rows` and :func:`exchange_queue`
over all shards at once and rebuilds each shard's table with
``insert_or_find``; the host tier (a physical grow or a compaction)
remaps through numpy and rebuilds each table on the engine's device.
Growing needs no devices on a world of one: it widens the leading
dimension; over ranks the new count must split evenly.  ``run``
takes an ``AutoscalePolicy`` (scale and rebalance at declared ticks) or
a closed-loop ``LoadAutoscaler`` (``telemetry/controller.py``).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from repro_torch._device import resolve_device, torch_dtype
from repro_torch.core import apply as apply_mod
from repro_torch.core import queues as q_mod
from repro_torch.core.durability import (DurabilityConfig, EngineDurability,
                                         merge_replay_ticks, stage_sources)
from repro_torch.core.engine import EngineConfig, resolve_key_dtype
from repro_torch.core.event import EventBatch, concat, tree_map
from repro_torch.core.hashing import HashRing, route, route_secondary
from repro_torch.core.operators import (AssociativeUpdater, Mapper,
                                        SequentialUpdater, Updater)
from repro_torch.core.queues import OverflowPolicy
from repro_torch.core.workflow import Workflow
from repro_torch.kernels.slate_lookup import ops as lk_ops
from repro_torch.slates import flush as flush_mod
from repro_torch.slates import table as tbl
from repro_torch.slates.flush import FlushPolicy
from repro_torch.telemetry import latency as lat_mod
from repro_torch.telemetry import sketch as sk_mod
from repro_torch.telemetry.controller import LoadAutoscaler
from repro_torch.telemetry.metrics import MetricsRegistry, TelemetryConfig
from repro_torch.telemetry.trace import ControlLog, Tracer, null_span


# ---- the mesh ----------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """The part of a device mesh the engine reads: ordered axis names
    and their sizes, and the process group whose ranks hold the shards
    (``None``: every shard on the engine's one device)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    group: Any = field(default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              group=None) -> Mesh:
    """``make_mesh((8,), ("data",))``, ``make_mesh((2, 4), ("pod",
    "data"))``: the shard grid.  ``group`` (a ``torch.distributed``
    process group, e.g. ``dist.group.WORLD``) spreads the shards over its
    ranks in contiguous blocks; the shard count must split evenly over
    them, as the JAX package needs a device a shard."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "must pair up one to one")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh axes need at least one shard: {shape}")
    mesh = Mesh(axis_names, shape, group)
    _check_split(int(np.prod(shape)), mesh.world)
    return mesh


def _check_split(n_shards: int, world: int):
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split evenly over "
                         f"{world} ranks: each rank holds n_shards / world "
                         f"of them")


def linear_shard_index(coords: Dict[str, int], mesh: Mesh,
                       axis_names: Sequence[str]) -> int:
    """A shard's index along the state's leading dimension from its mesh
    coordinates over ``axis_names``: ``np.prod`` order, the trailing axis
    fastest (the JAX package's ``_linear_shard_index``)."""
    idx = 0
    for a in axis_names:
        idx = idx * mesh.shape[a] + int(coords[a])
    return idx


def _salt(name: str) -> int:
    h = 2166136261
    for c in name.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h


# ---- collectives --------------------------------------------------------

# calls of each collective the engine made, by name: tests and the card
# check read them (one ``all_to_all_single`` a hop, one ``all_gather`` a
# read); never reset here
COLLECTIVES: Dict[str, int] = {"all_to_all_single": 0, "all_gather": 0,
                               "all_gather_object": 0, "gather_object": 0,
                               "broadcast": 0}


def _layout(xs: Sequence[torch.Tensor]) -> List[int]:
    """The order of ``xs`` in a packed row: widest element first, so each
    field starts at a multiple of its own element size."""
    return sorted(range(len(xs)), key=lambda i: -xs[i].element_size())


def _pack(xs: Sequence[torch.Tensor], rows: int) -> torch.Tensor:
    """Tensors with a leading dim ``rows`` as one ``[rows, bytes]`` uint8
    buffer (any dtype, bool and bf16 included), in :func:`_layout` order,
    each row padded to a multiple of the widest element size so that
    :func:`_unpack` returns aligned views."""
    parts = [xs[i].contiguous().reshape(rows, -1).view(torch.uint8)
             for i in _layout(xs)]
    pad = -sum(p.shape[1] for p in parts) % max(x.element_size()
                                                 for x in xs)
    if pad:
        parts.append(parts[0].new_zeros((rows, pad)))
    return torch.cat(parts, dim=1)


def _unpack(buf: torch.Tensor, xs: Sequence[torch.Tensor]):
    """Split a packed ``[rows, bytes]`` buffer (offset 0 in its storage)
    back into tensors of the dtypes of ``xs``, each ``[rows, -1]``: views
    of ``buf``, no copy."""
    out, off = [None] * len(xs), 0
    for i in _layout(xs):
        x = xs[i]
        n = x[0].numel() * x.element_size() if x.shape[0] else 0
        out[i] = buf[:, off:off + n].view(x.dtype)
        off += n
    return out


def all_to_all_rows(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The bucket exchange of :func:`exchange`, :func:`exchange_rows` and
    :func:`exchange_queue`: every ``x`` is ``[n, L_src * cap, ...]`` (row
    d: this rank's buckets for shard d).  One ``all_to_all_single`` of
    equal splits sends rows ``[r*L, (r+1)*L)`` to rank r; what arrives is
    ``[world_src, L_dst, L_src * cap, ...]``, reordered here to ``[L_dst,
    n * cap, ...]`` source-shard major (source 0's bucket first), the
    order of the JAX package's ``all_to_all``.  Without a group the
    input is already that layout."""
    if group is None:
        return list(xs)
    world = dist.get_world_size(group)
    n = xs[0].shape[0]
    buf = _pack(xs, n)
    out = torch.empty_like(buf)
    COLLECTIVES["all_to_all_single"] += 1
    dist.all_to_all_single(out, buf, group=group)
    res = []
    for x, part in zip(xs, _unpack(out, xs)):
        tail = tuple(x.shape[1:])
        part = part.reshape((world, n // world) + tail).transpose(0, 1)
        res.append(part.reshape((n // world, world * tail[0]) + tail[1:]))
    return res


def all_gather_rows(xs: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """Each ``x`` ``[k, ...]`` on every rank -> ``[world * k, ...]``, rank
    order, in one ``all_gather`` of a packed buffer.  Identity without a
    group."""
    if group is None or not xs:
        return list(xs)
    world = dist.get_world_size(group)
    k = xs[0].shape[0]
    buf = _pack(xs, k)
    parts = [torch.empty_like(buf) for _ in range(world)]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(parts, buf, group=group)
    full = torch.cat(parts, dim=0)
    return [p.reshape((world * k,) + tuple(x.shape[1:]))
            for x, p in zip(xs, _unpack(full, xs))]


def all_gather_tree(tree, group):
    """A tree of ``[k, ...]`` tensors gathered to ``[world * k, ...]``
    leaves in one collective."""
    if group is None:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(all_gather_rows(leaves, group), spec)


def gather_objects(obj, group) -> Optional[List[Any]]:
    """Every rank's ``obj`` (picklable host data) on rank 0 of ``group``,
    rank order; ``None`` on the other ranks."""
    if group is None:
        return [obj]
    root = dist.get_rank(group) == 0
    out = [None] * dist.get_world_size(group) if root else None
    COLLECTIVES["gather_object"] += 1
    dist.gather_object(obj, out, dst=dist.get_global_rank(group, 0),
                       group=group)
    return out


def all_gather_objects(obj, group) -> List[Any]:
    """Every rank's ``obj`` (picklable host data), rank order."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    COLLECTIVES["all_gather_object"] += 1
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, group):
    """Rank 0's ``obj`` on every rank."""
    if group is None:
        return obj
    box = [obj]
    COLLECTIVES["broadcast"] += 1
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def broadcast_tensor(t: torch.Tensor, group):
    """Rank 0's ``t`` into every rank's ``t`` (in place, any backend)."""
    COLLECTIVES["broadcast"] += 1
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)


def _group_block(group, rows: int) -> int:
    """The first global shard index of this rank's block of ``rows``."""
    return 0 if group is None else dist.get_rank(group) * rows


# ---- the exchange ------------------------------------------------------

def exchange(batch: EventBatch, dest: torch.Tensor, n_shards: int,
             cap_per_dest: int, group=None) -> Tuple[EventBatch, torch.Tensor]:
    """Route events to their destination shards.

    ``batch`` holds the ``[L, B]`` batches of this rank's L source shards
    (all ``n_shards`` without a group) and ``dest`` ``[L, B]`` their
    destinations.  Per (source, destination) bucket at most
    ``cap_per_dest`` events pass, in their batch order; the rest are
    dropped and counted (bounded queues, paper section 4.3).  Returns
    the batches this rank's shards receive, ``[L, n_shards *
    cap_per_dest]`` — row d holds source 0's bucket for d, then source
    1's, ..., the order ``all_to_all`` delivers — and the drops per
    source shard ``[L]``.  With ``group``, one ``all_to_all_single``
    moves the buckets.
    """
    S, B = batch.key.shape
    n, cap = n_shards, cap_per_dest
    dev = batch.key.device
    d = torch.where(batch.valid, dest.to(torch.int64), n)    # invalid: sink
    # rank among the row's events for the same destination (stable): a
    # running count a destination, scanned along the contiguous last dim
    onehot = torch.zeros((S, n + 1, B), dtype=torch.int32, device=dev)
    onehot.scatter_(1, d[:, None, :], 1)
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32).gather(
        1, d[:, None, :])[:, 0] - 1
    ok = batch.valid & (d < n) & (pos < cap)
    dropped = (batch.valid & (d < n) & ~ok).sum(dim=1, dtype=torch.int32)
    src = torch.arange(S, dtype=torch.int64, device=dev)[:, None]
    flat = torch.where(ok, (d * S + src) * cap + pos, n * S * cap)
    put = lambda a, fill=0: _deliver(a, flat.reshape(-1), n, cap, fill)
    leaves, spec = pytree.tree_flatten(batch.value)
    got = all_to_all_rows([put(batch.sid), put(batch.ts), put(batch.key),
                           *[put(v) for v in leaves], put(ok, False)], group)
    received = EventBatch(
        sid=got[0], ts=got[1], key=got[2],
        value=pytree.tree_unflatten(got[3:-1], spec), valid=got[-1])
    return received, dropped


def _buckets(dest: torch.Tensor, n_shards: int, cap: int):
    """The ``all_to_all`` bucket layout of stacked ``[S, L]`` destinations
    of S local source rows (``n_shards`` = no destination): each row
    stably ordered by
    destination, each entry ranked among its row's entries for the same
    destination (the JAX package's ``argsort`` + ``searchsorted``).
    Returns ``(order, flat, ok, lost)``: the order, each sorted entry's
    cell in the received ``[S_dst, S_src * cap]`` layout flattened (the
    sink ``n * S * cap`` where it does not fit), whether it fits, and the
    entries per source row that did not fit.  A sort, not
    :func:`exchange`'s running count: the ``[S, n + 1, L]`` one-hot of a
    table's ``L = C`` rows would not fit (1.1 GB at C = 2**20, 16
    shards)."""
    S, L = dest.shape
    n = n_shards
    order = torch.argsort(dest, dim=1, stable=True)
    sdest = torch.gather(dest, 1, order)
    pos = torch.arange(L, device=dest.device) - torch.searchsorted(
        sdest, sdest, side="left")
    ok = (sdest < n) & (pos < cap)
    lost = ((sdest < n) & ~ok).sum(dim=1, dtype=torch.int32)
    src = torch.arange(S, device=dest.device)[:, None]
    flat = torch.where(ok, (sdest * S + src) * cap + pos, n * S * cap)
    return order, flat.reshape(-1), ok, lost


def _deliver(x: torch.Tensor, flat, n_shards: int, cap: int, fill
             ) -> torch.Tensor:
    """Scatter stacked ``[S, L, ...]`` entries to their cells ``flat``
    (``[S * L]``, in the entries' order; the sink ``n_shards * S * cap``
    takes the rest): the bucket layout :func:`all_to_all_rows` sends.
    Returns ``[n_shards, S * cap, ...]``, row d holding local source 0's
    bucket for d, then source 1's, ...; cells no entry reached keep
    ``fill``."""
    S = x.shape[0]
    tail = tuple(x.shape[2:])
    sink = n_shards * S * cap
    out = torch.full((sink + 1,) + tail, fill, dtype=x.dtype, device=x.device)
    out.index_put_((flat,), x.reshape((-1,) + tail))
    return out[:sink].view((n_shards, S * cap) + tail)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` at the even and ``b`` at the odd positions of dim 1.  Floats
    come out as ``x + 0`` (-0.0 becomes 0.0), as JAX's pad-and-add
    interleave gives them."""
    out = torch.empty((a.shape[0], a.shape[1] + b.shape[1])
                      + tuple(a.shape[2:]), dtype=a.dtype, device=a.device)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out + 0 if out.is_floating_point() else out


def associative_scan(fn, elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan along dim 1 of a list of ``[S, L, ...]`` tensors
    with the associative ``fn(list, list) -> list``: the odd/even
    recursion of ``jax.lax.associative_scan``, so ``fn`` combines the
    same elements in the same tree, and a float fold rounds as the JAX
    package's."""
    L = elems[0].shape[1]
    if L < 2:
        return elems
    reduced = fn([e[:, 0:L - 1:2] for e in elems],
                 [e[:, 1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    if L % 2 == 0:
        even = fn([o[:, :-1] for o in odd], [e[:, 2::2] for e in elems])
    else:
        even = fn(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def exchange_rows(t: tbl.SlateTable, dest_salt: int, ring_hashes,
                  ring_shards, n_shards: int, cap_per_dest: int, combine,
                  group=None) -> Tuple[tbl.SlateTable, torch.Tensor]:
    """Slate-row migration as one exchange (DESIGN.md section 14.1): the
    table-row counterpart of :func:`exchange`, over the stacked
    ``[L, C+1]`` tables of this rank's shards at once (every shard
    without a group).

    Each shard routes its rows through the *new* ring, packs movers
    ``(key, value, ts, dirty)`` into per-destination buckets of
    ``cap_per_dest`` rows, and each destination rebuilds its table from
    stayers + arrivals: the candidates sorted valid first and by key
    (two stable sorts), duplicate keys folded with the updater's
    ``combine`` (else last-ts-wins) in one segmented scan, one
    representative a key inserted into a fresh table.  Folded rows are
    dirty with the largest ts; rows that do not fit (bucket overflow,
    full table) are dropped and counted.  The JAX package runs this a
    shard under ``shard_map`` with an ``all_to_all``; here the buckets
    are one scatter (and, with ``group``, one ``all_to_all_single``) and
    the rebuild one ``insert_or_find`` a shard (on the card, the lookup
    kernel's ``find`` route).  Returns ``(new_table, moved_out [L])``."""
    S, n, cap = t.keys.shape[0], n_shards, cap_per_dest
    C = t.capacity
    dev = t.keys.device
    keys = t.keys[:, :C]
    valid = keys != tbl.EMPTY
    owner = route(keys, dest_salt, ring_hashes, ring_shards).long()
    me = torch.arange(S, device=dev)[:, None]
    mover = valid & (owner != me + _group_block(group, S))
    moved_out = mover.sum(dim=1, dtype=torch.int32)

    # pack movers into per-destination buckets (the exchange() layout)
    order, flat, ok, lost = _buckets(torch.where(mover, owner, n), n, cap)
    put = lambda x, fill: _deliver(x[me, order], flat, n, cap, fill)
    vleaves, vspec = pytree.tree_flatten(t.vals)
    got = all_to_all_rows(
        [_deliver(ok, flat, n, cap, False), put(keys, tbl.EMPTY),
         put(t.ts[:, :C], 0), put(t.dirty[:, :C], False),
         *[put(v[:, :C], 0) for v in vleaves]], group)
    rvalid, rkeys, rts, rdirty = got[:4]
    rvals = pytree.tree_unflatten(got[4:], vspec)

    # candidates = stayers and arrivals; sorted valid first, by key (two
    # stable passes), so a key's rows are adjacent and one scan folds them
    stay = valid & ~mover
    cat = lambda a, b: torch.cat([a, b], dim=1)
    ckeys, cvalid = cat(keys, rkeys), cat(stay, rvalid)
    o1 = torch.argsort(ckeys, dim=1, stable=True)
    first = torch.where(torch.gather(cvalid, 1, o1), 0, 1).to(torch.int32)
    order2 = torch.gather(o1, 1, torch.argsort(first, dim=1, stable=True))
    rows = torch.arange(S, device=dev)[:, None]
    take = lambda x: x[rows, order2]
    ks, vs = take(ckeys), take(cvalid)
    ts_s, dt_s = take(cat(t.ts[:, :C], rts)), take(cat(t.dirty[:, :C],
                                                        rdirty))
    vleaves, vspec = pytree.tree_flatten(
        tree_map(lambda a, b: take(cat(a[:, :C], b)), t.vals, rvals))

    no = torch.zeros((S, 1), dtype=torch.bool, device=dev)
    prev_same = cat(no, (ks[:, 1:] == ks[:, :-1]) & vs[:, 1:] & vs[:, :-1])

    def fold(a, b):
        fa, ta, da, *va = a
        fb, tb, db, *vb = b
        if combine is not None:
            merged = pytree.tree_flatten(combine(
                pytree.tree_unflatten(va, vspec),
                pytree.tree_unflatten(vb, vspec)))[0]
        else:
            newer = tb >= ta
            merged = [torch.where(_bshape(newer, x), y, x)
                      for x, y in zip(va, vb)]
        v = [torch.where(_bshape(fb, y), y, m.to(y.dtype))
             for m, y in zip(merged, vb)]
        return [fa | fb, torch.where(fb, tb, torch.maximum(ta, tb)),
                torch.where(fb, db, torch.ones_like(db)), *v]

    _, fts, fdirty, *fvals = associative_scan(
        fold, [~prev_same, ts_s, dt_s, *vleaves])
    fvals = pytree.tree_unflatten(fvals, vspec)

    # one representative a key: the last row of its sorted run holds the
    # whole fold; a run of one keeps its own ts and dirty
    rep = vs & ~cat(prev_same[:, 1:], no)
    out = []
    for d in range(S):
        fresh = tbl.SlateTable(
            keys=torch.full_like(t.keys[d], tbl.EMPTY),
            ts=torch.zeros_like(t.ts[d]),
            dirty=torch.zeros_like(t.dirty[d]),
            vals=tree_map(lambda v: torch.zeros_like(v[d]), t.vals),
            dropped=t.dropped[d] + lost[d])
        fresh, slot, _, placed = tbl.insert_or_find(fresh, ks[d], rep[d])
        safe = torch.where(placed, slot, C)
        tree_map(lambda dst, src: dst.index_put_((safe,), src[d].to(
            dst.dtype)), fresh.vals, fvals)
        fresh.ts.index_put_((safe,), fts[d])
        fresh.dirty.index_put_((safe,), fdirty[d])
        fresh.dropped = fresh.dropped + (rep[d] & ~placed).sum(
            dtype=torch.int32)
        out.append(fresh)
    return _stack(out), moved_out


def exchange_queue(q: q_mod.QueueState, dest_salt: int, ring_hashes,
                   ring_shards, n_shards: int, cap_per_dest: int,
                   group=None) -> Tuple[q_mod.QueueState, torch.Tensor]:
    """Queued-event re-homing as one exchange: the queue counterpart of
    :func:`exchange_rows`, over the stacked ``[L, Q+1]`` queues, so a
    planned leave with backlog (``drain_max=0``, or a drain barrier that
    could not retire the queues) stays on the device tier.

    Every in-``size`` slot is read in dequeue order and routed by its
    key's *primary* owner on the new ring (validity flags ride along as
    payload, as in the host scan); stayers go through the buckets too,
    so each destination rebuilds its queue compacted at head 0 in
    (source shard ascending, dequeue order), the host migrator's order.
    ``dropped`` carries plus any overflow (bucket or destination
    capacity); ``peak`` restarts at the new backlog, a tensor of its own
    (the tick updates state in place).  With ``group``, one
    ``all_to_all_single`` moves the buckets.  Returns
    ``(new_queue, moved_out [L])``."""
    S, n, cap = q.size.shape[0], n_shards, cap_per_dest
    buf = q.buf
    Q = buf.key.shape[1] - 1           # the sink row aside
    dev = q.size.device
    ar = torch.arange(Q, dtype=torch.int32, device=dev)
    pos = ((q.head[:, None] + ar) % Q).long()
    live = ar < q.size[:, None]
    rows = torch.arange(S, device=dev)[:, None]
    at = lambda x: x[rows, pos]
    key = at(buf.key)
    owner = route(key, dest_salt, ring_hashes, ring_shards).long()
    moved_out = (live & (owner != rows + _group_block(group, S))).sum(
        dim=1, dtype=torch.int32)

    # every live event goes through the buckets, so arrival order is
    # (source, dequeue order) alone: the host rebuild's order
    order, flat, ok, lost = _buckets(torch.where(live, owner, n), n, cap)
    put = lambda x, fill: _deliver(at(x)[rows, order], flat, n, cap, fill)
    vleaves, vspec = pytree.tree_flatten(buf.value)
    got = all_to_all_rows(
        [_deliver(ok, flat, n, cap, False), put(buf.sid, 0), put(buf.ts, 0),
         put(buf.key, 0), put(buf.valid, False),
         *[put(v, 0) for v in vleaves]], group)
    rlive, rsid, rts, rkey, rvflag = got[:5]
    rvals = pytree.tree_unflatten(got[5:], vspec)

    # compact arrivals at head 0 (the sink row Q takes what does not fit)
    rank = torch.cumsum(rlive.to(torch.int32), dim=1, dtype=torch.int32) - 1
    fits = rlive & (rank < Q)
    size = fits.sum(dim=1, dtype=torch.int32)
    tgt = torch.where(fits, rank, Q).long()

    def scat(src, fill):
        b = torch.full((S, Q + 1) + tuple(src.shape[2:]), fill,
                       dtype=src.dtype, device=dev)
        b[rows, tgt] = src
        return b

    nbuf = EventBatch(sid=scat(rsid, 0), ts=scat(rts, 0), key=scat(rkey, 0),
                      value=tree_map(lambda v: scat(v, 0), rvals),
                      valid=scat(rvflag, False))
    drops = lost + (rlive & ~fits).sum(dim=1, dtype=torch.int32)
    return q_mod.QueueState(buf=nbuf, head=torch.zeros_like(q.head),
                            size=size, dropped=q.dropped + drops,
                            peak=size.clone()), moved_out


# ---- stacked-state helpers ---------------------------------------------

def _bshape(mask, like):
    return mask.reshape(tuple(mask.shape) + (1,) * (like.ndim - mask.ndim))


def _row(tree, s: int):
    """Shard ``s`` of a stacked tree: views of every leaf."""
    return tree_map(lambda x: x[s], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _restack(stacked, parts):
    """Shard ``parts`` (trees of views of ``stacked``'s rows, some leaves
    replaced by the single-shard functions) back into one stacked tree:
    a leaf every shard updated in place stays the stacked tensor, any
    other is stacked anew (one operation a leaf)."""
    leaves, spec = pytree.tree_flatten(stacked)
    per = [pytree.tree_flatten(p)[0] for p in parts]
    out = []
    for i, st in enumerate(leaves):
        ps = [p[i] for p in per]
        step = st.stride(0) * st.element_size()
        base = st.data_ptr()
        if all(p.data_ptr() == base + s * step and p.shape == st.shape[1:]
               for s, p in enumerate(ps)):
            out.append(st)
        else:
            out.append(torch.stack(ps))
    return pytree.tree_unflatten(out, spec)


def _stack_ticks(per_tick: Sequence[Dict[str, EventBatch]]
                 ) -> Dict[str, EventBatch]:
    """T per-tick dicts of ``[S, B]`` source batches -> ``[T, S, B]``.
    A stream missing from a tick becomes an all-invalid batch; smaller
    batches are padded with invalid rows along B (neither changes a
    tick's result: invalid events never leave the exchange)."""
    caps: Dict[str, int] = {}
    tmpl: Dict[str, EventBatch] = {}
    for d in per_tick:
        for s, b in d.items():
            if s not in caps or b.key.shape[1] > caps[s]:
                caps[s], tmpl[s] = b.key.shape[1], b

    def pad(a, cap):
        extra = cap - a.shape[1]
        if extra == 0:
            return a
        z = torch.zeros((a.shape[0], extra) + tuple(a.shape[2:]),
                        dtype=a.dtype, device=a.device)
        return torch.cat([a, z], dim=1)

    def get(d, s):
        if s in d:
            return tree_map(lambda a: pad(a, caps[s]), d[s])
        t = tmpl[s]
        return t.mask(torch.zeros_like(t.valid))

    return {s: _stack([get(d, s) for d in per_tick]) for s in tmpl}


# ---- configuration -----------------------------------------------------

@dataclass
class AutoscalePolicy:
    """Declarative elasticity for ``DistributedEngine.run`` (DESIGN.md
    section 12): scale the active shard set at given source ticks and/or
    rebalance the weighted ring from the per-shard load signal every k
    source ticks.  Exposed through the front door as
    ``RuntimeConfig(autoscale=AutoscalePolicy(...))``."""

    scale_at: Dict[int, int] = field(default_factory=dict)
    # source tick -> target active shard count (fires before that tick)
    rebalance_every: int = 0     # source ticks between reweights; 0 = off
    drain_max: int = 64          # drain-barrier bound per reconfigure
    on_change: Optional[Any] = None  # callback(MigrationReport)


@dataclass
class MigrationReport:
    """What a live reconfigure moved (scale / rebalance / leave)."""

    n_shards: int                # physical shard slots after
    active: List[int]            # active shard ids after
    drain_ticks: int             # barrier ticks run before migration
    moved_rows: Dict[str, int]   # slate rows re-homed, per updater
    moved_events: Dict[str, int]  # queued events re-homed, per operator
    recompiled: bool             # physical shape change (grow/compact)
    pause_s: float = 0.0         # wall seconds the stream stood still
    bytes_moved: int = 0         # payload re-homed (rows + events)
    path: str = "host"           # "device" (exchange) or "host" remap


@dataclass
class DistConfig(EngineConfig):
    exchange_slack: float = 2.0   # per-dest bucket capacity multiplier
    two_choice_threshold: int = 0  # 0 = off; else per-key spill point
    axis_names: Tuple[str, ...] = ("data",)
    # tick-scheduled AutoscalePolicy, or a closed-loop LoadAutoscaler
    # driven by the telemetry subsystem (DESIGN.md 13.3)
    autoscale: Optional[Any] = None
    # hot-key split set capacity (fixed shape).  0 = no split routing in
    # the tick; > 0 opts in, and a LoadAutoscaler with skew > 0 implies
    # 8.  Needs cfg.telemetry and no durability.
    hot_key_capacity: int = 0
    # migration tier (DESIGN.md 14.1): "auto" re-homes slate rows and any
    # queued backlog with the device exchange at reconfigures that keep
    # the physical shapes; "off" forces the host remap everywhere
    device_migration: str = "auto"
    # physical slot compaction (DESIGN.md 14.2): when a deactivation
    # leaves >= this fraction of slots dead, shrink the state to the
    # active set and free the parked slots' memory.  0 disables;
    # compact() forces it.
    compact_threshold: float = 0.75


# ---- the engine --------------------------------------------------------

class DistributedEngine:
    """State lives stacked on dim 0 (the shard axis) of every leaf, on
    ``device`` (default ``cuda``; ``device="cpu"`` runs on the CPU).  On
    a mesh with a process group each rank holds its block of ``n_local``
    shards from ``shard_lo`` on (pass the rank's own device:
    ``cuda:LOCAL_RANK`` under NCCL, ``cpu`` under gloo), and every rank
    calls every method in the same order: the exchanges, reads, stats
    and reconfigures are collectives."""

    def __init__(self, workflow: Workflow, mesh: Mesh,
                 config: Optional[DistConfig] = None, device=None):
        self.wf = workflow
        self.mesh = mesh
        self.cfg = config or DistConfig()
        self.device = resolve_device(device)
        self.key_dtype = resolve_key_dtype(self.cfg.key_dtype)
        self.axes = tuple(self.cfg.axis_names)
        self.n_shards = int(np.prod([mesh.shape[a] for a in self.axes]))
        self.group = mesh.group
        self.world, self.rank = mesh.world, mesh.rank
        self._set_block()
        self.ring = HashRing(self.n_shards)
        self._upload_ring()
        cap = int(self.cfg.batch_size * self.cfg.exchange_slack
                  / self.n_shards)
        self.cap_per_dest = max(8, cap)
        # serializes slate readers against run(), which updates the
        # state in place chunk by chunk, and against reconfigures; the
        # StateHandle run() was given is republished inside it
        self.read_lock = threading.RLock()
        self._live_handle = None
        self._load_mark = np.zeros(self.n_shards)  # rebalance window base
        self.tick_cursor = 0      # post-run() *source* cursor
        self.dur: Optional[EngineDurability] = None
        if self.cfg.durability is not None:
            self.attach_durability(self.cfg.durability)
        # a closed-loop controller implies telemetry
        tele = self.cfg.telemetry
        if tele is None and isinstance(self.cfg.autoscale, LoadAutoscaler):
            tele = self.cfg.autoscale.telemetry or TelemetryConfig()
        self.tele_cfg = tele
        self.telemetry: Optional[MetricsRegistry] = None
        self.tracer: Optional[Tracer] = None
        self._ctl_log: Optional[ControlLog] = None
        if tele is not None:
            self.telemetry = MetricsRegistry(
                tele, batch_size=self.cfg.batch_size)
            self._salts = self.telemetry.salts
            if tele.trace:
                self.tracer = Tracer()
            if tele.control_log:
                self._ctl_log = ControlLog(tele.control_log)
        # hot-key split set: a fixed-shape runtime input of the tick, so
        # splits swap contents, never shapes
        hot_cap = self.cfg.hot_key_capacity
        if (hot_cap == 0 and isinstance(self.cfg.autoscale, LoadAutoscaler)
                and self.cfg.autoscale.skew > 0.0):
            hot_cap = 8
        self._hot_capacity = (hot_cap if tele is not None
                              and self.cfg.durability is None else 0)
        kd_np = np.int64 if self.key_bits == 64 else np.int32
        self._hot_keys = np.zeros(max(1, self._hot_capacity), kd_np)
        self._hot_valid = np.zeros(max(1, self._hot_capacity), bool)
        self._hot_dev = None
        self._hot_table()

    def _set_block(self):
        """This rank's block of the shard index: ``n_local`` shards from
        ``shard_lo`` (all of them without a group)."""
        _check_split(self.n_shards, self.world)
        self.n_local = self.n_shards // self.world
        self.shard_lo = self.rank * self.n_local

    def _local(self, batch: EventBatch) -> EventBatch:
        """This rank's rows of a global ``[n_shards, B]`` source batch (a
        view; a batch of ``n_local`` rows is taken as this rank's
        already).  Every rank makes the same global feed from the seed,
        so taking the block moves nothing."""
        if self.world == 1 or batch.key.shape[0] != self.n_shards:
            return batch
        lo, hi = self.shard_lo, self.shard_lo + self.n_local
        return tree_map(lambda a: a[lo:hi], batch)

    def _upload_ring(self):
        """Copy the ring to the device now, on the host's schedule: the
        tick reads the cached copy and never copies (a copy from
        pageable host memory would sync the host)."""
        self.ring.table(self.device)

    @property
    def key_bits(self) -> int:
        return self.key_dtype.itemsize * 8

    def _span(self, name: str, **args):
        """Tracer span when tracing is on, else a free no-op."""
        return self.tracer.span(name, **args) if self.tracer \
            else null_span(**args)

    # ---- state ----
    def init_state(self) -> Dict[str, Any]:
        S, kd, dev = self.n_local, self.key_dtype, self.device

        def per_shard(one):
            return tree_map(
                lambda x: x[None].expand((S,) + tuple(x.shape)).clone(), one)

        queues = {op.name: per_shard(q_mod.make_queue(
            self.cfg.queue_capacity, op.in_value_spec, key_dtype=kd,
            device=dev)) for op in self.wf.operators}
        tables = {up.name: per_shard(tbl.make_table(
            up.table_capacity, up.slate_spec(), key_dtype=kd, device=dev))
            for up in self.wf.updaters()}
        z = lambda: torch.zeros(S, dtype=torch.int32, device=dev)
        state = {
            "queues": queues, "tables": tables,
            "tick": z(),
            "exchange_dropped": z(),
            "throttle_hits": z(),
            "deferred": z(),
            "processed": {op.name: z() for op in self.wf.operators},
        }
        tc = self.tele_cfg
        if tc is not None:
            state["sketch"] = per_shard(sk_mod.make_sketch(
                tc.depth, tc.width, tc.sample, key_dtype=kd, device=dev))
            if tc.latency_buckets > 0:
                state["lat_hist"] = per_shard(lat_mod.make_hist(
                    [u.name for u in self.wf.updaters()],
                    tc.latency_buckets, device=dev))
        return state

    # ---- the tick, stage by stage over the shards ----
    def _tick(self, state, sources: Dict[str, EventBatch]):
        cfg, wf, S = self.cfg, self.wf, self.n_local
        rh, rs = self.ring.table(self.device)
        hot_keys, hot_valid = self._hot_table()
        sources = {s: self._local(b) for s, b in sources.items()}
        for s, b in sources.items():
            if b.device != self.device:
                raise ValueError(f"source {s!r} is on {b.device}, the "
                                 f"engine on {self.device}")
        queues = {k: [_row(q, s) for s in range(S)]
                  for k, q in state["queues"].items()}
        tables = {k: [_row(t, s) for s in range(S)]
                  for k, t in state["tables"].items()}
        tick = state["tick"]
        ticks = [tick[s] for s in range(S)]
        exchange_dropped = state["exchange_dropped"]
        throttle_hits = state["throttle_hits"]
        deferred_n: List[torch.Tensor] = []
        processed_n: Dict[str, List[torch.Tensor]] = {}
        sketch = [_row(state["sketch"], s) for s in range(S)] \
            if "sketch" in state else None
        lat_hist = {k: [_row(h, s) for s in range(S)]
                    for k, h in state["lat_hist"].items()} \
            if "lat_hist" in state else None
        outputs: Dict[str, List[EventBatch]] = {}

        def deliver_all(items):
            """Route stacked batches to their subscribers' queues, one
            exchange a (stream, subscriber) pair; the overflow-stream
            work list is the same on every shard, as in the JAX tick."""
            nonlocal throttle_hits, exchange_dropped
            work = deque(items)
            for _ in range(len(work) + 64):
                if not work:
                    return
                stream, batch = work.popleft()
                subs = wf.dests_of(stream)
                if not subs:
                    outputs.setdefault(stream, []).append(batch)
                    continue
                for dest_op in subs:
                    op = wf.by_name[dest_op]
                    dshard = route(batch.key, _salt(dest_op), rh, rs)
                    if (cfg.two_choice_threshold
                            and isinstance(op, AssociativeUpdater)):
                        dshard = self._two_choice(batch, dshard, dest_op,
                                                  rh, rs)
                    elif (self._hot_capacity
                            and isinstance(op, AssociativeUpdater)):
                        dshard = self._hot_split(batch, dshard, dest_op,
                                                 rh, rs, hot_keys,
                                                 hot_valid, tick)
                    recv, dropped = exchange(batch, dshard, self.n_shards,
                                             self.cap_per_dest, self.group)
                    exchange_dropped = exchange_dropped + dropped
                    pol = cfg.policy_for(dest_op)
                    ovfs, hits = [], []
                    for s in range(S):
                        nq, ovf = q_mod.enqueue(queues[dest_op][s],
                                                _row(recv, s))
                        if pol is OverflowPolicy.DROP:
                            nq = q_mod.count_drop(nq, ovf)
                        elif pol is OverflowPolicy.OVERFLOW_STREAM:
                            ovfs.append(ovf)
                        elif pol is OverflowPolicy.THROTTLE:
                            hits.append(ovf.count())
                            nq = q_mod.count_drop(nq, ovf)
                        queues[dest_op][s] = nq
                    if ovfs:
                        work.append((cfg.overflow_stream[dest_op],
                                     _stack(ovfs)))
                    if hits:
                        throttle_hits = throttle_hits + torch.stack(hits)
            raise RuntimeError("overflow-stream routing did not converge "
                               "(cycle in overflow_stream config?)")

        deliver_all(list(sources.items()))
        emitted_now: List[Tuple[str, EventBatch]] = []

        def emit_stacked(per_shard: List[Dict[str, EventBatch]]):
            for stream in per_shard[0]:
                emitted_now.append(
                    (stream, _stack([e[stream] for e in per_shard])))

        for op in wf.operators:
            batches = []
            for s in range(S):
                queues[op.name][s], b = q_mod.dequeue(queues[op.name][s],
                                                      cfg.batch_size)
                batches.append(b)
            if sketch is not None and isinstance(op, Updater):
                # per-shard key heat from the routed keys each shard's
                # updaters dequeue: state the tick never reads
                for s, b in enumerate(batches):
                    sketch[s] = sk_mod.sketch_update(
                        sketch[s], b.key, b.valid, self._salts,
                        impl=self.tele_cfg.impl)
            if lat_hist is not None and isinstance(op, Updater):
                for s, b in enumerate(batches):
                    lat_hist[op.name][s] = lat_mod.hist_update(
                        lat_hist[op.name][s], ticks[s], b.ts, b.valid,
                        n_buckets=self.tele_cfg.latency_buckets,
                        impl=self.tele_cfg.impl)
            ns = []
            if isinstance(op, Mapper):
                outs = []
                for b in batches:
                    o = op.map_batch(b)
                    outs.append({st: eb.mask(b.valid & eb.valid)
                                 for st, eb in o.items()})
                    ns.append(b.count())
                emit_stacked(outs)
            elif isinstance(op, AssociativeUpdater):
                ems = []
                for s, b in enumerate(batches):
                    tables[op.name][s], em, n = apply_mod.apply_associative(
                        op, tables[op.name][s], b, ticks[s], impl=cfg.fused)
                    ems.append(em)
                    ns.append(n)
                emit_stacked(ems)
            elif isinstance(op, SequentialUpdater):
                ems = []
                for s, b in enumerate(batches):
                    tables[op.name][s], em, deferred, n = \
                        apply_mod.apply_sequential(op, tables[op.name][s],
                                                   b, ticks[s])
                    ems.append(em)
                    deferred_n.append(deferred.count())
                    nq, ovf = q_mod.enqueue(queues[op.name][s], deferred)
                    queues[op.name][s] = q_mod.count_drop(nq, ovf)
                    ns.append(n)
                emit_stacked(ems)
            else:
                raise TypeError(f"unknown operator type {type(op)}")
            processed_n[op.name] = ns

        for up in wf.updaters():
            if up.ttl:
                for s in range(S):
                    tables[up.name][s] = tbl.expire_ttl(
                        tables[up.name][s], ticks[s], up.ttl)

        deliver_all(emitted_now)

        out_batches = {s: tree_map(lambda *xs: torch.cat(xs, dim=1), *bs)
                       if len(bs) > 1 else bs[0]
                       for s, bs in outputs.items()}
        deferred = state["deferred"]
        if deferred_n:
            deferred = deferred + torch.stack(deferred_n)
        new_state = {
            "queues": {k: _restack(state["queues"][k], v)
                       for k, v in queues.items()},
            "tables": {k: _restack(state["tables"][k], v)
                       for k, v in tables.items()},
            "tick": tick + 1,
            "exchange_dropped": exchange_dropped,
            "throttle_hits": throttle_hits,
            "deferred": deferred,
            "processed": {k: v + torch.stack(processed_n[k])
                          for k, v in state["processed"].items()},
        }
        if sketch is not None:
            new_state["sketch"] = _restack(state["sketch"], sketch)
        if lat_hist is not None:
            new_state["lat_hist"] = {k: _restack(state["lat_hist"][k], v)
                                     for k, v in lat_hist.items()}
        return new_state, out_batches

    def _two_choice(self, batch, primary, dest_op, ring_hashes,
                    ring_shards):
        """Spill a key's per-tick excess (its events past the first
        ``two_choice_threshold`` of the shard's batch) to its secondary
        shard."""
        secondary = route_secondary(batch.key, _salt(dest_op), ring_hashes,
                                    ring_shards)
        key_sink = torch.where(
            batch.valid, batch.key,
            torch.iinfo(batch.key.dtype).max)
        order = torch.argsort(key_sink, dim=1, stable=True)
        sk = torch.gather(key_sink, 1, order)
        B = sk.shape[1]
        rank_sorted = torch.arange(B, device=sk.device) - \
            torch.searchsorted(sk, sk, side="left")
        rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
        spill = rank >= self.cfg.two_choice_threshold
        return torch.where(spill, secondary, primary)

    def _hot_split(self, batch, primary, dest_op, ring_hashes, ring_shards,
                   hot_keys, hot_valid, tick):
        """Runtime hot-key relief (DESIGN.md 13.4): events whose key is
        in the hot set alternate between the key's primary and secondary
        shard by the parity of row index ^ tick.  An empty set leaves
        routing bit-identical."""
        secondary = route_secondary(batch.key, _salt(dest_op), ring_hashes,
                                    ring_shards)
        is_hot = ((batch.key[..., None] == hot_keys) & hot_valid).any(-1)
        B = batch.key.shape[1]
        rows = torch.arange(B, dtype=torch.int32, device=tick.device)
        flip = ((rows[None, :] ^ tick[:, None]) & 1) == 1
        return torch.where(is_hot & flip & batch.valid, secondary, primary)

    def _hot_table(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The hot-key split set on the engine's device, uploaded when it
        changes (``split_keys`` uploads it, so a tick never does)."""
        if self._hot_dev is None:
            self._hot_dev = (
                torch.from_numpy(self._hot_keys.copy()).to(
                    self.device, self.key_dtype),
                torch.from_numpy(self._hot_valid.copy()).to(self.device))
        return self._hot_dev

    # ---- host API ----
    def step(self, state, sources: Dict[str, EventBatch]):
        """One tick.  ``sources``: ``[n_shards, B]``-leading batches (each
        rank takes its block's rows; ``[n_local, B]`` is taken as the
        block).  Updates ``state`` in place (use the returned one);
        returns ``(state, outputs)`` with ``[n_local, ...]`` output
        batches."""
        return self._tick(state, sources)

    def run_chunk(self, state, stacked_sources: Dict[str, EventBatch],
                  n_ticks: Optional[int] = None):
        """T ticks with no host sync between them.

        ``stacked_sources`` leaves are ``[T, n_shards, B, ...]``.
        Returns ``(state, stacked_outputs, info)``; output leaves are
        ``[T, n_local, ...]`` and ``info['throttle_hits']`` is the
        ``[T, n_local]`` on-device per-tick trace.  Bitwise equal to T
        ``step`` calls.  An empty ``stacked_sources`` runs ``n_ticks``
        source-less ticks."""
        lead = {s: b.key.shape[0] for s, b in stacked_sources.items()}
        t_dim = next(iter(lead.values())) if lead else n_ticks
        if t_dim is None:
            raise ValueError("empty stacked_sources needs an explicit "
                             "n_ticks")
        if n_ticks is not None and lead and t_dim != n_ticks:
            raise ValueError(f"stacked sources have {t_dim} ticks, "
                             f"caller asked for {n_ticks}")
        outs_per_tick, hits = [], []
        for t in range(t_dim):
            src = {s: _row(b, t) for s, b in stacked_sources.items()}
            state, outs = self._tick(state, src)
            outs_per_tick.append(outs)
            hits.append(state["throttle_hits"])
        stacked_outs = {s: _stack([o[s] for o in outs_per_tick])
                        for s in (outs_per_tick[0] if outs_per_tick
                                  else {})}
        return state, stacked_outs, {"throttle_hits": torch.stack(hits)}

    def _step_empty(self, state):
        """One source-less tick (drain barriers, replay gap ticks)."""
        state, _ = self._tick(state, {})
        return state

    def _drain_queues(self, state, max_ticks: int):
        """Source-less ticks until every shard's queues are empty (one
        host read a probe, of every rank's backlog).  Returns ``(state,
        ticks_run)``."""
        d = 0
        while d < max_ticks:
            sizes = torch.stack([q.size for q in state["queues"].values()])
            total, = all_gather_rows([sizes.sum(dtype=torch.int64)[None]],
                                     self.group)
            if int(total.sum().item()) == 0:
                break
            state = self._step_empty(state)
            d += 1
        return state, d

    def drain(self, state, max_ticks: int = 64):
        """Run source-less ticks until every shard's queues are empty
        (or ``max_ticks``).  Returns ``(state, ticks_run)``."""
        return self._drain_queues(state, max_ticks)

    # ---- durability (DESIGN.md section 10): per-shard WAL + frontier --
    def attach_durability(self, cfg: DurabilityConfig):
        """One WAL per shard, one shared slate store, one barrier
        frontier.  Incompatible with two-choice dispatch: partial
        aggregates of one key on two shards would clobber each other in
        the store.  Over ranks, a rank opens and writes only its own
        shards' WALs; rank 0 writes the store and the frontier."""
        if self.cfg.two_choice_threshold:
            raise ValueError("durability requires two_choice_threshold=0 "
                             "(per-key partials are not store-mergeable)")
        fresh = not os.path.exists(cfg.frontier_path())
        self.dur = EngineDurability(cfg, self.wf, self.cfg.queue_capacity,
                                    self.cfg.batch_size,
                                    n_shards=self.n_local,
                                    first=self.shard_lo)
        if self.group is not None and fresh:
            # no frontier file yet: start from every shard's log end
            self.dur.frontier.wal_offset = self._all_offsets()

    def _all_offsets(self) -> List[int]:
        """Every shard's current WAL end offset, gathered from the ranks
        that own them (rank order = shard order)."""
        return [o for offs in all_gather_objects(self.dur._offsets(),
                                                 self.group) for o in offs]

    def _record_frontier(self, tick: int, meta=None):
        """``dur.record_frontier`` over ranks: each rank fences its own
        WALs and captures their offsets, the ranks' lists are gathered
        (so every append the frontier covers is on disk on every rank
        first), rank 0 alone saves the file, after its flusher drained
        the store writes, and no rank goes on before it is saved."""
        f_tick, offs = self.dur.begin_frontier(tick)
        every = [o for part in all_gather_objects(offs, self.group)
                 for o in part]
        self.dur.commit_frontier((f_tick, every), meta=meta,
                                 save=self.rank == 0)
        if self.group is not None:
            dist.barrier(group=self.group)

    def _resize_durability(self):
        """Match the WAL set to the new shard count (after a reconfigure's
        flush barrier).  Over ranks the block may have moved: each rank
        reopens its block's WALs, the frontier keeps the old shards'
        offsets and takes the new shards' current ends from every rank,
        and rank 0 saves it."""
        self.dur.resize(self.n_shards, first=self.shard_lo,
                        n_local=self.n_local, offsets=self._all_offsets,
                        save=self.rank == 0)
        if self.group is not None:
            dist.barrier(group=self.group)

    def append_sources(self, tick: int, sources: Dict[str, EventBatch]):
        """Write-ahead: log each shard's row of the ``[n_shards, B]``
        source batches to that shard's WAL (call before the tick runs).

        The host copy is issued here (pinned, behind an event on the
        card); the per-shard slicing and the appends run on the
        durability writer thread, so the dispatch path pays only the
        enqueue.  A stream with no valid event on a shard is not logged
        for that shard.  A rank logs its own block's rows."""
        staged, event = stage_sources(
            {s: self._local(b) for s, b in sources.items()})
        n_shards, dur = self.n_local, self.dur

        def _log():
            if event is not None:
                event.synchronize()
            for sh in range(n_shards):
                sl = {s: _row(b, sh) for s, b in staged.items()}
                sl = {s: b for s, b in sl.items() if bool(b.valid.any())}
                dur._do_append(int(tick), sl, sh)

        dur.append_deferred(_log)

    def _flush_due_in(self, eng_tick: int) -> int:
        """Ticks until the flush policy fires, as the JAX engine checks
        it after every tick: a chunk ends there so the boundary falls on
        the same engine tick."""
        fc = self.dur.cfg.flush
        if fc.policy is FlushPolicy.EVERY_K:
            k = fc.every_k
            return max(1, k * (self.dur.frontier.tick // k + 1) - eng_tick)
        return 1

    def _shard_tables(self, state):
        return {f"{k}/{s}": _row(t, s) for k, t in state["tables"].items()
                for s in range(self.n_local)}

    def _flush_due(self, eng_tick: int, state) -> bool:
        """``dur.due`` at a chunk boundary.  The occupancy policy reads
        each rank's tables, so the ranks' answers are or-ed."""
        due = self.dur.due(eng_tick, self._shard_tables(state))
        if self.group is not None and self.dur.cfg.flush.policy not in (
                FlushPolicy.IMMEDIATE, FlushPolicy.EVERY_K):
            due = any(all_gather_objects(due, self.group))
        return due

    def _flush_boundary(self, state, tick: int, meta=None):
        """Barrier-drain, flush every shard's dirty slates, record the
        frontier.  ``meta`` is the driver cursor stored with it.

        The JAX package hands the store one batch a (updater, shard);
        here an updater's shards go as one batch, rows in shard order.
        A key lives on one shard (durability refuses per-key partials),
        so the store files are the same bytes, and each segment file is
        rewritten once a flush instead of once a shard."""
        dur = self.dur
        if dur.cfg.barrier:
            state, d = self._drain_queues(state, dur.cfg.drain_ticks_max)
            tick += d
        tokens = [(up, [flush_mod.begin_dirty_snapshot(
            _row(state["tables"][up.name], sh))
            for sh in range(self.n_local)]) for up in self.wf.updaters()]
        for up, toks in tokens:
            rows = [flush_mod.finish_dirty_snapshot(t) for t in toks]
            # over ranks, rank 0 writes every rank's rows, in shard order
            parts = gather_objects(rows, self.group)
            if parts is None:
                continue
            rows = [r for part in parts for r in part]
            keys, ts, vals = (np.concatenate([r[0] for r in rows]),
                              np.concatenate([r[1] for r in rows]),
                              tree_map(lambda *v: np.concatenate(v),
                                       *[r[2] for r in rows]))
            dur.flusher.flush_rows(up.name, keys, ts, vals, up.ttl)
        self._record_frontier(tick, meta=meta)
        return state, tick

    def run(self, state, source_fn, n_ticks: int, *, start_tick: int = 0,
            handle=None):
        """Host driver (the shape of ``Engine.run``):
        ``source_fn(tick, max_events) -> dict[stream, EventBatch]`` with
        ``[n_shards, B]``-leading batches; ``max_events`` is always
        ``None`` (per-shard backpressure is the exchange and queue
        bound).  Returns ``(state, outputs)``, one output dict a source
        tick; the source cursor after the run is ``self.tick_cursor``.

        Ticks run in chunks of ``cfg.chunk_size`` with no host sync
        inside; a chunk also ends where the JAX engine, which checks
        after every tick, would flush (durability on) or read telemetry
        (every ``window`` source ticks), so both happen on the same tick.
        With durability, each tick's sources are logged per shard before
        it runs, and drain ticks of a flush barrier advance the engine
        tick but not ``source_fn``'s index.  ``handle`` (a
        ``StateHandle``) is republished after every chunk and every
        reconfigure, and each time it drains its read queue there
        (``StateHandle.drain``, a collective on a group when the handle
        serves; nothing otherwise), so a served read sees the state of a
        chunk boundary.

        With ``cfg.autoscale`` set to an :class:`AutoscalePolicy`, the
        loop fires live reconfigures at the policy's source-tick
        boundaries: ``scale_at[t]`` rescales the active shard set before
        tick ``t`` runs, and every ``rebalance_every`` ticks the weighted
        ring is rebuilt from the per-shard load signal.  With a
        :class:`~repro_torch.telemetry.controller.LoadAutoscaler` the
        loop closes instead: every decision window the telemetry
        registry reads the boundary signals and the controller picks
        scale / rebalance / split (DESIGN.md 13.3).  No chunk crosses a
        reconfigure.  Either way ``source_fn`` must size its batches by
        the *current* ``self.n_shards``."""
        pol = self.cfg.autoscale
        self._live_handle = handle
        if pol is None:
            return self._run_span(state, source_fn, n_ticks,
                                  start_tick=start_tick, handle=handle)
        if isinstance(pol, LoadAutoscaler):
            return self._run_closed_loop(state, source_fn, n_ticks, pol,
                                         start_tick=start_tick,
                                         handle=handle)
        end = start_tick + n_ticks
        marks = {t for t in pol.scale_at if start_tick <= t < end}
        if pol.rebalance_every:
            marks |= {t for t in range(start_tick, end)
                      if t > start_tick
                      and (t - start_tick) % pol.rebalance_every == 0}
        outputs: List[Dict[str, Any]] = []
        t = start_tick
        self.tick_cursor = t
        for boundary in sorted(marks) + [end]:
            if boundary > t:
                state, outs = self._run_span(state, source_fn,
                                             boundary - t, start_tick=t,
                                             handle=handle)
                outputs.extend(outs)
                t = boundary
            if boundary < end:          # fire before tick `boundary` runs
                if boundary in pol.scale_at:
                    state, rep = self.scale(state, pol.scale_at[boundary],
                                            drain_max=pol.drain_max)
                else:
                    state, rep = self.rebalance(state,
                                                drain_max=pol.drain_max)
                if rep is not None and pol.on_change is not None:
                    pol.on_change(rep)
                if handle is not None:
                    handle.state = state
                    handle.drain(t)
        self.tick_cursor = max(t, self.tick_cursor)
        return state, outputs

    def _run_closed_loop(self, state, source_fn, n_ticks: int, pol, *,
                         start_tick: int = 0, handle=None):
        """Observe -> decide -> act (DESIGN.md 13.3): run one decision
        window of source ticks, take the boundary telemetry reading, and
        let the :class:`LoadAutoscaler` choose an actuator.  The sketch
        ages at every window so heat stays recent.  Without
        ``max_shards`` the ceiling is the physical slot count when the
        run starts (the JAX package's visible devices): the loop
        reactivates parked slots but does not grow."""
        assert self.telemetry is not None
        outputs: List[Dict[str, Any]] = []
        t = start_tick
        end = start_tick + n_ticks
        limit = pol.max_shards or self.n_shards
        lead = self._lead_axis_size()
        if lead > 1:
            # multi-axis meshes grow along their trailing axis, so the
            # reachable ceiling is the largest multiple of the leading
            # axes' product (never below the current physical size)
            limit = max(self.n_shards, (limit // lead) * lead)
        while t < end:
            n = min(pol.window - (t - start_tick) % pol.window, end - t)
            state, outs = self._run_span(state, source_fn, n,
                                         start_tick=t, handle=handle)
            outputs.extend(outs)
            t += n
            with self._span("telemetry_observe", tick=t):
                report = self.telemetry.observe(self, state)
            if "sketch" in state:
                state = dict(state)
                state["sketch"] = sk_mod.decay(state["sketch"],
                                               self.tele_cfg.decay)
            action = pol.decide(
                report, n_active=len(self.active_shards), limit=limit,
                can_split=(self.dur is None and self._hot_capacity > 0),
                already_split=tuple(self.split_key_set()))
            # the report is the same on every rank, but the cooldown may
            # read wall-clock pauses: every rank takes rank 0's action
            action = broadcast_object(action, self.group)
            rep = None
            if action is not None and t < end:
                t0 = time.perf_counter()
                if action.kind == "scale":
                    state, rep = self.scale(state, action.target,
                                            drain_max=pol.drain_max)
                elif action.kind == "rebalance":
                    w = pol.heat_weights(report, owners=self.heat_owners)
                    state, rep = self.rebalance(state, weights=w,
                                                drain_max=pol.drain_max)
                elif action.kind == "split":
                    state, rep = self.split_keys(state, action.keys)
                self.telemetry.note_pause(
                    rep.pause_s if rep is not None
                    else time.perf_counter() - t0,
                    bytes_moved=rep.bytes_moved if rep is not None else 0)
                self.telemetry.rebase(self, state)
                if rep is not None and pol.on_change is not None:
                    pol.on_change(rep)
                if handle is not None:
                    handle.state = state
                    handle.drain(t)
            if self._ctl_log is not None:
                self._ctl_log.log({
                    "tick": t,
                    "pressure": [float(x) for x in
                                 np.asarray(report.pressure).ravel()],
                    "event_latency_p99": report.event_latency_p99,
                    "queue_depth": float(
                        np.asarray(report.queue_depth).sum()),
                    "n_active": len(self.active_shards),
                    "action": None if action is None else {
                        "kind": action.kind, "target": action.target,
                        "keys": [int(k) for k in action.keys],
                        "reason": action.reason},
                    "applied": None if rep is None else {
                        "path": rep.path, "pause_s": rep.pause_s,
                        "moved_rows": rep.moved_rows,
                        "bytes_moved": rep.bytes_moved},
                })
        self.tick_cursor = t
        return state, outputs

    def _run_span(self, state, source_fn, n_ticks: int, *,
                  start_tick: int = 0, handle=None):
        outputs: List[Dict[str, Any]] = []
        src_t, end = start_tick, start_tick + n_ticks
        self._live_handle = handle
        eng_tick = int(state["tick"].max().item()) \
            if self.dur is not None else 0
        # a closed-loop controller observes at its own decision windows
        observe = (self.telemetry is not None
                   and not isinstance(self.cfg.autoscale, LoadAutoscaler))
        window = self.tele_cfg.window if observe else 0
        obs_mark = start_tick
        while src_t < end:
            n = min(self.cfg.chunk_size, end - src_t)
            if observe:
                n = min(n, obs_mark + window - src_t)
            if self.dur is not None:
                n = min(n, self._flush_due_in(eng_tick))
            per_tick = [source_fn(src_t + i, None) for i in range(n)]
            if self.dur is not None:
                for i, srcs in enumerate(per_tick):
                    self.append_sources(eng_tick + i, srcs)
            # the chunk updates the state in place: readers wait until
            # the new state is republished
            with self.read_lock:
                with self._span("chunk_dispatch", tick=src_t, n_ticks=n):
                    state, outs, _ = self.run_chunk(
                        state, _stack_ticks(per_tick), n)
                for i in range(n):
                    outputs.append({s: _row(b, i) for s, b in outs.items()})
                src_t += n
                eng_tick += n
                if self.dur is not None and self._flush_due(eng_tick,
                                                            state):
                    with self._span("flush_boundary", tick=eng_tick,
                                    source_tick=src_t):
                        state, eng_tick = self._flush_boundary(
                            state, eng_tick, meta={"source_tick": src_t})
                    if handle is not None:
                        handle.on_frontier_advance()
                if observe and src_t - obs_mark >= window:
                    with self._span("telemetry_observe", tick=src_t):
                        report = self.telemetry.observe(self, state)
                    if handle is not None:
                        handle.on_telemetry(report)
                    state = dict(state)
                    state["sketch"] = sk_mod.decay(state["sketch"],
                                                   self.tele_cfg.decay)
                    obs_mark = src_t
                if handle is not None:
                    handle.state = state
                    handle.drain(src_t)
        self.tick_cursor = src_t
        if self.dur is not None:
            with self._span("wal_fence"):
                self.dur.fence()
        return state, outputs

    def run_durable(self, state, source_fn, n_ticks: int, *,
                    start_tick: int = 0, handle=None):
        """Durable host driver: ``source_fn(tick)`` returns ``[n_shards,
        B]``-leading source batches.  Returns ``(state,
        next_source_tick)``; a thin wrapper over :meth:`run` (``handle``
        republished and drained as there)."""
        assert self.dur is not None, "attach_durability first"
        state, _ = self.run(state, lambda t, _mx: source_fn(t), n_ticks,
                            start_tick=start_tick, handle=handle)
        return state, self.tick_cursor

    def recover(self, *, frontier=None):
        """Rebuild the stacked state after losing any subset of shards:
        flushed slates are re-inserted on whatever shard the *current*
        ring routes them to (so a dead shard's keys land on survivors),
        then each shard's WAL suffix replays through the tick, which
        re-routes every replayed event with the current ring.  The log's
        batches come back on the CPU and move to the engine's device.

        Over ranks every rank reads every shard's WAL (the other ranks'
        read-only) and the store, and keeps its own block: the WALs and
        store of any world size recover on any other."""
        from repro_torch.slates.wal import WriteAheadLog
        dur = self.dur
        assert dur is not None, "attach_durability first"
        t_recover = time.perf_counter()
        frontier = frontier or dur.frontier
        f_tick = int(frontier.tick)
        offs = list(frontier.wal_offset) \
            if isinstance(frontier.wal_offset, (list, tuple)) \
            else [frontier.wal_offset] * self.n_shards
        if len(offs) < self.n_shards:   # replay newer WALs from the start
            offs += [0] * (self.n_shards - len(offs))
        # every shard's log: this rank's own, the others' read-only; a
        # frontier from a larger shard set: the extra shards' WAL
        # suffixes replay too, re-routed by the current ring
        lo, hi = self.shard_lo, self.shard_lo + self.n_local
        extra_wals = [WriteAheadLog(dur.cfg.wal_path(s), read_only=True)
                      for s in range(len(offs)) if not lo <= s < hi]
        readers = iter(extra_wals)
        wals = [dur.wals[s - lo] if lo <= s < hi else next(readers)
                for s in range(len(offs))]

        state = self.init_state()
        state["tick"].fill_(f_tick)
        with self._span("recover_restore", frontier=f_tick) as sp:
            sp["rows"] = 0
            for up in self.wf.updaters():
                rows = dur.store.scan_rows(up.name,
                                           now=f_tick if up.ttl else None)
                if rows is None:
                    continue
                ks, ts, slates = rows
                ks = ks.astype(np.int64 if self.key_bits == 64
                               else np.int32)
                shard_of = self.ring.owners(ks, _salt(up.name)) - lo
                t = state["tables"][up.name]
                local = [_row(t, sh) for sh in range(self.n_local)]
                for sh in range(self.n_local):
                    sel = np.nonzero(shard_of == sh)[0]
                    if len(sel):
                        local[sh] = flush_mod.restore_into(
                            local[sh], ks[sel],
                            tree_map(lambda a: a[sel], slates), ts[sel])
                state["tables"][up.name] = _restack(t, local)
                sp["rows"] += len(ks)

        chunk = self.cfg.chunk_size
        pending: List[Dict[str, EventBatch]] = []
        replayed = 0

        def flush_pending():
            nonlocal state, pending, replayed
            while pending:
                group, pending = pending[:chunk], pending[chunk:]
                if any(group):
                    state, _, _ = self.run_chunk(state, _stack_ticks(group),
                                                 len(group))
                else:
                    state, _, _ = self.run_chunk(state, {}, len(group))
                replayed += len(group)

        with self._span("recover_replay", frontier=f_tick) as sp:
            cur = f_tick
            try:
                for tk, by_shard in merge_replay_ticks(wals, offs):
                    if tk < f_tick:
                        continue
                    if len(offs) > self.n_shards:
                        by_shard = self._fold_shard_sources(by_shard)
                    while cur < tk:
                        pending.append({})
                        cur += 1
                    pending.append(self._stack_shard_sources(by_shard))
                    cur += 1
                    if len(pending) >= 4 * chunk:
                        flush_pending()
                flush_pending()
            finally:
                for w in extra_wals:
                    w.close()
            sp["replayed_ticks"] = replayed
        if self.group is not None:
            # no rank appends to its log before every rank has read it
            dist.barrier(group=self.group)
        if self.telemetry is not None:
            self.telemetry.note_recovery(time.perf_counter() - t_recover)
        return state

    def _fold_shard_sources(self, by_shard: Dict[int, Dict[str, Any]]
                            ) -> Dict[int, Dict[str, Any]]:
        """Fold replay records from shard slots beyond the current
        physical size onto live slots (the tick re-routes every event by
        key, so the source slot is irrelevant)."""
        folded: Dict[int, Dict[str, Any]] = {}
        for sh, src in sorted(by_shard.items()):
            tgt = sh % self.n_shards
            cur = folded.setdefault(tgt, {})
            for s, b in src.items():
                cur[s] = b if s not in cur else concat([cur[s], b])
        return folded

    def _stack_shard_sources(self, by_shard: Dict[int, Dict[str, Any]]
                             ) -> Dict[str, EventBatch]:
        """Per-shard replay records -> ``[n_shards, B]`` source batches on
        the engine's device (missing shards and streams become
        all-invalid rows)."""
        caps: Dict[str, int] = {}
        tmpl: Dict[str, EventBatch] = {}
        for src in by_shard.values():
            for s, b in src.items():
                if s not in caps or b.capacity > caps[s]:
                    caps[s], tmpl[s] = b.capacity, b

        def one(sh, s):
            b = by_shard.get(sh, {}).get(s)
            if b is None:
                t = tmpl[s]
                return tree_map(torch.zeros_like, t.pad_to(caps[s]))
            return b.pad_to(caps[s])

        return {s: tree_map(lambda x: x.to(self.device), _stack(
            [one(sh, s) for sh in range(self.n_shards)])) for s in tmpl}

    def close(self):
        if self.dur is not None:
            self.dur.close()
        if self._ctl_log is not None:
            self._ctl_log.close()

    # ---- failure (host side; the master of paper section 4.3) ----
    def fail_shard(self, state, shard: int):
        """Machine crash: re-route the ring; the dead shard's unflushed
        slates and queued events are lost (paper semantics).  The ring
        keeps its shape, so nothing else changes.  Updates ``state`` in
        place and returns it.  Over ranks every rank re-routes (the ring
        is replicated) and the rank that holds the shard clears it."""
        self.ring.fail(shard)
        self._upload_ring()
        s = shard - self.shard_lo
        if not 0 <= s < self.n_local:
            return state
        for q in state["queues"].values():
            for leaf in pytree.tree_leaves(q):
                leaf[s].zero_()
        for t in state["tables"].values():
            t.keys[s].fill_(tbl.EMPTY)
            t.dirty[s].zero_()
        return state

    @property
    def active_shards(self) -> List[int]:
        return [int(s) for s in np.nonzero(self.ring.alive)[0]]

    def shard_load(self, state) -> np.ndarray:
        """Per-shard pressure signal from the queue stats: high-water
        marks + backlog, drops weighted heavier.  ``[n_shards]``, every
        rank's shards gathered."""
        load = np.zeros(self.n_shards)
        qs = all_gather_tree([(q.peak, q.size, q.dropped)
                              for q in state["queues"].values()], self.group)
        for peak, size, dropped in qs:
            g = lambda x: x.cpu().numpy().astype(np.float64)
            load += g(peak) + g(size) + 4.0 * g(dropped)
        return load

    # ---- live elasticity (DESIGN.md section 12) ----
    def scale(self, state, new_n_shards: int, *, drain_max: int = 64):
        """Live resize to ``new_n_shards`` *active* shards, loss-free.

        Scale-up reactivates dead slots first (a ring swap, shapes
        kept), then grows the physical slot count if needed (the one
        move that widens the state).  Scale-down deactivates the
        highest-numbered active shards and migrates everything off
        them.  Returns ``(state, MigrationReport)``."""
        if new_n_shards < 1:
            raise ValueError("need at least one active shard")
        active = self.active_shards
        if new_n_shards == len(active):
            return state, self._report(0, {}, {}, recompiled=False)
        if new_n_shards < len(active):
            return self.remove_shards(state, active[new_n_shards:],
                                      drain_max=drain_max)
        dead = [s for s in range(self.n_shards) if not self.ring.alive[s]]
        activate = dead[:new_n_shards - len(active)]
        grow_to = new_n_shards if len(active) + len(activate) \
            < new_n_shards else None
        if grow_to is not None:
            _check_split(grow_to, self.world)
        return self._reconfigure(state, grow_to=grow_to,
                                 activate=activate, drain_max=drain_max)

    def add_shards(self, state, k: int, *, drain_max: int = 64):
        """Grow the active shard set by ``k`` (elastic join)."""
        return self.scale(state, len(self.active_shards) + k,
                          drain_max=drain_max)

    def remove_shards(self, state, shards, *, drain_max: int = 64):
        """Planned leave: migrate the given shards' slates and queued
        events to the survivors, then deactivate them — loss-free,
        unlike :meth:`fail_shard`.  The slots stay allocated (rejoin
        them with :meth:`scale`) unless the dead share reaches
        ``compact_threshold``."""
        shards = [int(s) for s in np.atleast_1d(shards)]
        for s in shards:
            if s >= self.n_shards or not self.ring.alive[s]:
                raise ValueError(f"shard {s} is not active")
        if len(self.active_shards) - len(shards) < 1:
            raise ValueError("cannot remove every active shard")
        return self._reconfigure(state, deactivate=shards,
                                 drain_max=drain_max)

    def _rebase_load_window(self, state, load: Optional[np.ndarray] = None):
        """Restart the rebalance load window at the current pressure, so
        the next window's delta measures only load accrued after this
        point (queue peaks restart at migrations, and back-to-back
        ``rebalance()`` calls must see an empty window)."""
        self._load_mark = self.shard_load(state) if load is None else load

    def rebalance(self, state, *, gain: float = 0.5, floor: float = 0.25,
                  cap: float = 4.0, drain_max: int = 64, weights=None):
        """Load-aware ring reweighting: shards whose queues ran hot since
        the last rebalance shed vnode arcs (key ranges) to cold shards.
        A ring swap and a row migration, shapes kept.  ``weights``:
        explicit per-shard targets (e.g. ``LoadAutoscaler.heat_weights``)
        in place of the queue-delta heuristic, clipped to ``[floor,
        cap]``.  A reweight that would move no vnode is skipped.
        Returns ``(state, report_or_None)``."""
        alive = self.ring.alive
        if weights is not None:
            w = np.clip(np.asarray(weights, np.float64), floor, cap)
            target = np.where(alive, w, self.ring.weights)
        else:
            load = self.shard_load(state)
            if load.shape != self._load_mark.shape:
                self._load_mark = np.zeros_like(load)
            delta = np.clip(load - self._load_mark, 0.0, None)
            mean = float(delta[alive].mean()) if alive.any() else 0.0
            if mean <= 0.0:
                self._rebase_load_window(state, load)
                return state, None
            # cold shards (delta < mean) gain weight, hot shards lose it;
            # gain damps the step, floor/cap bound the skew; dead slots
            # keep their stored weight (their zero load is absence)
            ratio = (mean + 1.0) / (delta + 1.0)
            target = self.ring.weights * np.power(ratio, gain)
            target = np.clip(target / target[alive].mean(), floor, cap)
            target = np.where(alive, target, self.ring.weights)
        if np.array_equal(self.ring.vnode_counts(),
                          self.ring.counts_for(target)):
            self._rebase_load_window(state)
            return state, None
        return self._reconfigure(state, weights=target,
                                 drain_max=drain_max)

    def clear_split(self, state, *, drain_max: int = 64):
        """Deactivate every hot-key split and converge the partials: one
        same-ring reconfigure whose table rebuild folds duplicate keys
        with the updater's combine, so each formerly split key ends up
        whole on its owner shard again."""
        if not self._hot_valid.any():
            return state, None
        with self.read_lock:
            self._hot_valid = np.zeros_like(self._hot_valid)
            self._hot_dev = None
            self._hot_table()
        return self._reconfigure(state, drain_max=drain_max)

    def compact(self, state, *, drain_max: int = 64):
        """Force physical slot compaction (DESIGN.md 14.2): shrink the
        state to the current active shard set, freeing the parked slots'
        memory, whatever ``compact_threshold`` says.  A no-op (``path``
        ``"none"``) when every slot is active.  Returns ``(state,
        MigrationReport)``."""
        if len(self.active_shards) == self.n_shards:
            return state, self._report(0, {}, {}, recompiled=False,
                                       path="none")
        return self._reconfigure(state, drain_max=drain_max,
                                 force_compact=True)

    def _report(self, drain_ticks, moved_rows, moved_events, *,
                recompiled: bool, pause_s: float = 0.0,
                bytes_moved: int = 0, path: str = "host"
                ) -> MigrationReport:
        return MigrationReport(
            n_shards=self.n_shards, active=self.active_shards,
            drain_ticks=drain_ticks, moved_rows=moved_rows,
            moved_events=moved_events, recompiled=recompiled,
            pause_s=pause_s, bytes_moved=bytes_moved, path=path)

    def _reconfigure(self, state, *, grow_to: Optional[int] = None,
                     activate=(), deactivate=(), weights=None,
                     drain_max: int = 64, force_compact: bool = False):
        """The migration behind scale / remove / rebalance / clear_split:

        1. drain-barrier the queues (and flush, with durability);
        2. swap in the new ring (membership, weights, physical size);
        3. re-home slate rows and queued events to their new owners: on
           the device when the physical shapes are kept
           (:func:`exchange_rows`, :func:`exchange_queue`), else the host
           remap, which rebuilds each table on the engine's device;
        4. copy the new ring (and the split set) to the device, outside
           any tick, and resume.

        Both tiers give bitwise-identical slates (DESIGN.md 14.3).  Runs
        under ``read_lock``: a concurrent reader sees the state before
        or after the migration, never a half-swapped ring; a published
        ``StateHandle`` is re-pointed before the lock is released."""
        with self.read_lock:
            with self._span("reconfigure") as sp:
                state, report = self._reconfigure_impl(
                    state, grow_to=grow_to, activate=activate,
                    deactivate=deactivate, weights=weights,
                    drain_max=drain_max, force_compact=force_compact)
                sp["pause_s"] = report.pause_s
                sp["path"] = report.path
                sp["n_shards"] = report.n_shards
                sp["drain_ticks"] = report.drain_ticks
            if self._live_handle is not None:
                self._live_handle.state = state
        return state, report

    def _reconfigure_impl(self, state, *, grow_to=None, activate=(),
                          deactivate=(), weights=None, drain_max=64,
                          force_compact=False):
        t_start = time.perf_counter()
        state, drained = self._drain_queues(state, drain_max)
        if self.dur is not None:
            tick = int(state["tick"].max().item())
            # the barrier retired every source fed so far: the frontier's
            # source cursor advances to the current one (monotone)
            prev = (self.dur.frontier.meta or {}).get("source_tick", 0)
            meta = {"source_tick": max(int(prev), int(self.tick_cursor))}
            state, _ = self._flush_boundary(state, tick, meta=meta)
        old_n = self.n_shards

        grew = grow_to is not None and grow_to > old_n
        if grew:
            self._grow_physical(grow_to)
        for s in activate:
            self.ring.join(int(s))
        for s in deactivate:
            self.ring.fail(int(s))
        if weights is not None:
            self.ring.set_weights(weights)

        compacting = False
        if not grew:
            n_active = len(self.active_shards)
            dead_frac = 1.0 - n_active / self.n_shards
            want = force_compact or (
                self.cfg.compact_threshold > 0.0
                and dead_frac >= self.cfg.compact_threshold)
            if want and n_active < self.n_shards:
                lead = self._lead_axis_size()
                if n_active % lead == 0 and n_active % self.world == 0:
                    compacting = True
                elif force_compact and n_active % lead:
                    raise ValueError(
                        f"cannot compact to {n_active} shards on a "
                        f"multi-axis mesh: the active count must be a "
                        f"multiple of the leading axes' product {lead}")
                elif force_compact:
                    _check_split(n_active, self.world)

        if not grew and not compacting \
                and self.cfg.device_migration != "off":
            state, moved_rows, moved_events, bytes_moved = \
                self._migrate_device(state)
            path = "device"
        else:
            # every rank remaps the whole state (gathered) with the same
            # numpy fold and keeps its new block
            host = tree_map(lambda x: x.cpu().numpy().copy(),
                            all_gather_tree(state, self.group))
            slot_map = None
            if grew:
                host = self._host_grow(host, old_n)
            if compacting:
                host, slot_map = self._compact_physical(host)
            moved_rows = self._migrate_tables_host(host["tables"],
                                                   slot_map=slot_map)
            moved_events = self._migrate_queues_host(host["queues"],
                                                     slot_map=slot_map)
            bytes_moved = self._bytes_of(moved_rows, moved_events)
            lo, hi = self.shard_lo, self.shard_lo + self.n_local
            state = tree_map(
                lambda a: torch.from_numpy(np.ascontiguousarray(
                    a[lo:hi])).to(self.device)
                if isinstance(a, np.ndarray) else a, host)
            path = "host"
        if self.dur is not None:
            self._resize_durability()
        # the ring and the split set changed: copy them to the device now,
        # so the next tick finds them there and never syncs the host
        self._upload_ring()
        self._hot_dev = None
        self._hot_table()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # queue peaks restarted at the migration: rebase the rebalance
        # window on the post-migration load
        self._rebase_load_window(state)
        return state, self._report(
            drained, moved_rows, moved_events,
            recompiled=grew or compacting,
            pause_s=time.perf_counter() - t_start,
            bytes_moved=bytes_moved, path=path)

    def _reset_queue_peaks(self, state):
        """Rebase every queue's high-water mark at its current backlog
        (a tensor of its own: the tick updates state in place)."""
        state = dict(state)
        state["queues"] = {
            name: q_mod.QueueState(buf=q.buf, head=q.head, size=q.size,
                                   dropped=q.dropped, peak=q.size.clone())
            for name, q in state["queues"].items()}
        return state

    def _lead_axis_size(self) -> int:
        """Product of every mesh axis size but the trailing one: the
        granularity physical grow and compaction must respect."""
        return int(np.prod([self.mesh.shape[a] for a in self.axes[:-1]],
                           dtype=np.int64)) if len(self.axes) > 1 else 1

    def _spec_bytes(self, spec) -> int:
        leaves = pytree.tree_flatten(spec, is_leaf=tbl._is_spec_leaf)[0]
        return sum(int(np.prod(shp, dtype=np.int64))
                   * torch_dtype(dt).itemsize for shp, dt in leaves)

    def _row_bytes(self, up) -> int:
        # key + ts + dirty + the slate
        return self.key_dtype.itemsize + 4 + 1 + \
            self._spec_bytes(up.slate_spec())

    def _event_bytes(self, op) -> int:
        # sid + ts + key + valid + the value
        return 4 * 2 + self.key_dtype.itemsize + 1 + \
            self._spec_bytes(op.in_value_spec)

    def _bytes_of(self, moved_rows, moved_events) -> int:
        total = sum(moved_rows.get(up.name, 0) * self._row_bytes(up)
                    for up in self.wf.updaters())
        total += sum(moved_events.get(op.name, 0) * self._event_bytes(op)
                     for op in self.wf.operators)
        return total

    def _migrate_device(self, state):
        """The device tier (DESIGN.md 14.1): count row movers and queued
        events per (source, destination) over every shard's table and
        queue at once, with one host read; pick power-of-two bucket
        capacities (the JAX package's jit-cache buckets, kept so the
        bucket shapes match); then :func:`exchange_rows` for every
        updater and :func:`exchange_queue` for every queue.  Slates and
        events never leave the device.  Returns ``(state, moved_rows,
        moved_events, bytes_moved)``."""
        updaters, operators = list(self.wf.updaters()), list(self.wf.operators)
        rh, rs = self.ring.table(self.device)
        tables, queues = state["tables"], state["queues"]
        n, L = self.n_shards, self.n_local
        rows = torch.arange(L, device=self.device)[:, None]
        me = rows + self.shard_lo          # the block's global shard ids

        def per_pair(dest, mask):
            pair = torch.where(mask, me * n + dest, n * n).reshape(-1)
            return torch.zeros(n * n + 1, dtype=torch.int64,
                               device=self.device).index_add_(
                0, pair, torch.ones_like(pair))[:n * n]

        counts = []
        for up in updaters:
            t = tables[up.name]
            keys = t.keys[:, :t.capacity]
            owner = route(keys, _salt(up.name), rh, rs).long()
            counts.append(per_pair(owner, (keys != tbl.EMPTY)
                                   & (owner != me)))
        for op in operators:
            q = queues[op.name]
            Q = q.buf.key.shape[1] - 1
            ar = torch.arange(Q, dtype=torch.int32, device=self.device)
            pos = ((q.head[:, None] + ar) % Q).long()
            owner = route(q.buf.key[rows, pos], _salt(op.name), rh,
                          rs).long()
            # every live event, stayers too: exchange_queue routes them
            # all through the buckets, so the cap must cover them
            counts.append(per_pair(owner, ar < q.size[:, None]))
        # a rank counts its own source rows: the ranks' plans add up to
        # the whole one, the same on every rank
        plan, = all_gather_rows([torch.stack(counts)[None]], self.group)
        plan = plan.sum(dim=0).cpu().numpy().reshape(-1, n, n)
        row_plan = dict(zip([u.name for u in updaters], plan))
        ev_plan = dict(zip([o.name for o in operators],
                           plan[len(updaters):]))
        moved = {name: int(c.sum()) for name, c in row_plan.items()}
        # event movers exclude the diagonal (stayers route to self)
        moved_ev = {name: int(c.sum() - np.trace(c))
                    for name, c in ev_plan.items()}
        maxc = max((int(c.max()) for c in row_plan.values()), default=0)
        ev_maxc = max((int(c.max()) for c in ev_plan.values()), default=0)
        bytes_moved = self._bytes_of(moved, moved_ev)
        if maxc == 0 and sum(moved_ev.values()) == 0:
            # nothing re-homes: tables and queues stand
            return self._reset_queue_peaks(state), moved, moved_ev, 0

        def pow2(c):
            cap = 8
            while cap < c:
                cap *= 2
            return cap
        cap_rows = pow2(maxc) if maxc else 0
        cap_ev = pow2(ev_maxc) if ev_maxc else 0
        state = dict(state)
        if cap_rows:
            state["tables"] = {
                up.name: exchange_rows(tables[up.name], _salt(up.name), rh,
                                       rs, n, cap_rows,
                                       getattr(up, "combine", None),
                                       self.group)[0]
                for up in updaters}
        if cap_ev:
            state["queues"] = {
                op.name: exchange_queue(queues[op.name], _salt(op.name), rh,
                                        rs, n, cap_ev, self.group)[0]
                for op in operators}
        else:       # no backlog anywhere: rebase the peaks
            state = self._reset_queue_peaks(state)
        return state, moved, moved_ev, bytes_moved

    def _grow_physical(self, new_n: int):
        """More shard slots: the leading dimension widens (on a world of
        one every slot is on the engine's one device, so no device count
        bounds it; over ranks ``new_n`` must split evenly over them, as
        the JAX package needs a device a shard).  Multi-axis meshes grow
        along their trailing axis (``('pod', 'data')`` keeps the pod
        count and widens each pod), so ``new_n`` must be a multiple of
        the leading axes' product."""
        _check_split(new_n, self.world)
        lead = self._lead_axis_size()
        if new_n % lead:
            raise ValueError(
                f"multi-axis mesh {self.mesh.shape} grows along its "
                f"trailing axis {self.axes[-1]!r}: target {new_n} must be "
                f"a multiple of {lead}")
        self.mesh = Mesh(self.axes, tuple(
            self.mesh.shape[a] for a in self.axes[:-1]) + (new_n // lead,),
            self.group)
        self.n_shards = new_n
        self.ring.grow(new_n)
        self._reset_for_new_shape()

    def _reset_for_new_shape(self):
        """Shared tail of grow and compaction: what depends on the shard
        count (the bucket capacity; the ring's device tables, which the
        ring's rebuild dropped, and the split set are copied again at the
        end of the reconfigure)."""
        cap = int(self.cfg.batch_size * self.cfg.exchange_slack
                  / self.n_shards)
        self.cap_per_dest = max(8, cap)
        self._hot_dev = None
        self._set_block()

    def _compact_physical(self, host):
        """Physical slot compaction (DESIGN.md 14.2): renumber the active
        shards onto a smaller state — the inverse of :meth:`_host_grow`,
        and the move that frees parked memory.  The ring is rebuilt at
        the new size (weights carried).

        Tables and queues stay at the *old* size here (dead slots may
        still hold rows); the host migrators the caller runs next scan
        every old slice.  Lifetime counters (the sketch's counts / total
        / sample_n, ``processed``, ``exchange_dropped``,
        ``throttle_hits``, ``deferred``, the table and queue ``dropped``
        tallies) fold from the dead slots into the first survivor before
        the slicing; the sketch's key sample is sliced.  Returns
        ``(host, slot_map)``: ``slot_map[d]`` is the old slot renumbered
        to new slot ``d``."""
        actives = self.active_shards
        k, old_n = len(actives), self.n_shards
        lead = self._lead_axis_size()
        self.mesh = Mesh(self.axes, tuple(
            self.mesh.shape[a] for a in self.axes[:-1]) + (k // lead,),
            self.group)
        self.n_shards = k
        self.ring = HashRing(k, vnodes=self.ring.vnodes,
                             weights=self.ring.weights[actives],
                             seed=self.ring.seed)
        self._reset_for_new_shape()
        idx = np.asarray(actives, np.int64)
        dead = np.asarray(sorted(set(range(old_n)) - set(actives)),
                          np.int64)

        def sel(a):
            return a[idx] if a.ndim >= 1 and a.shape[0] == old_n else a

        def fold(a):
            a = a.copy()
            if dead.size and a.ndim >= 1 and a.shape[0] == old_n:
                a[idx[0]] += a[dead].sum(axis=0).astype(a.dtype)
            return sel(a)

        counters = {"exchange_dropped", "throttle_hits", "deferred",
                    "processed"}
        out = {}
        for key, val in host.items():
            if key in ("tables", "queues"):
                out[key] = val
            elif key in counters:
                out[key] = tree_map(fold, val)
            elif key == "sketch":
                out[key] = {nm: fold(lf) if nm != "sample" else sel(lf)
                            for nm, lf in val.items()}
            else:
                out[key] = tree_map(sel, val)
        # the table and queue drop tallies stay at the old size for the
        # host migrators, which give new slot d old slot_map[d]'s: park
        # the dead slots' counts on the first survivor
        if dead.size:
            for part in ("tables", "queues"):
                for x in host[part].values():
                    x.dropped[idx[0]] += x.dropped[dead].sum(axis=0) \
                        .astype(x.dropped.dtype)
                    x.dropped[dead] = 0
        out["tick"] = np.full((k,), int(host["tick"].max()), np.int32)
        return out, [int(a) for a in actives]

    def _host_grow(self, host, old_n: int):
        """Pad every ``[old_n, ...]`` leaf to the new physical size:
        zeros for the new slots' queues, tables and counters (their
        table keys ``EMPTY``), the tick carried over."""
        pad_n = self.n_shards - old_n

        def pad(leaf, fill=0):
            if not (leaf.ndim >= 1 and leaf.shape[0] == old_n):
                return leaf
            ext = np.full((pad_n,) + leaf.shape[1:], fill, leaf.dtype)
            return np.concatenate([leaf, ext])

        out = tree_map(pad, host)
        out["tick"] = pad(host["tick"], fill=int(host["tick"].max()))
        for t in out["tables"].values():
            t.keys[old_n:] = tbl.EMPTY          # new slots start empty
        return out

    def _migrate_tables_host(self, tables, slot_map=None) -> Dict[str, int]:
        """Re-home slate rows whose ring owner changed (the host tier).

        Every shard's table is rebuilt from scratch, on the engine's
        device, rather than patched in place: deleting a moved-out row
        from an open-addressing table would cut the probe chains of the
        rows behind it.  Values move bit-exactly, ``ts`` and ``dirty``
        carry; same-key rows converging on one shard fold with the
        updater's combine (else last-ts-wins); rows a table cannot place
        are dropped and counted.  The input may have more slices than
        ``self.n_shards`` (compaction): every old slice is scanned and
        ``slot_map[d]`` names the old slot whose ``dropped`` tally new
        slot ``d`` inherits.  A rank builds its own block's tables only
        (``[n_local, ...]`` on its device); the counts are global."""
        moved: Dict[str, int] = {}
        n = self.n_shards
        block = range(self.shard_lo, self.shard_lo + self.n_local)
        smap = np.asarray(slot_map if slot_map is not None else range(n),
                          np.int64)
        for up in self.wf.updaters():
            t = tables[up.name]
            keys = t.keys[:, :-1]                   # the sink row aside
            old2new = np.full(keys.shape[0], -1, np.int64)
            old2new[smap] = np.arange(n)
            sh, slot = np.nonzero(keys != tbl.EMPTY)
            moved[up.name] = 0
            if len(sh) == 0:
                if keys.shape[0] != n:
                    tables[up.name] = _stack([self._build_local_table(
                        up, int(t.dropped[smap[d]]), keys[0, :0],
                        t.ts[0, :0], t.dirty[0, :0],
                        tree_map(lambda v: v[0, :0], t.vals))
                        for d in block])
                continue
            ts, dirty = t.ts[sh, slot], t.dirty[sh, slot]
            vals = tree_map(lambda v: v[sh, slot], t.vals)
            rkeys = keys[sh, slot]
            owner = self.ring.owners(rkeys, _salt(up.name))
            moved[up.name] = int((owner != old2new[sh]).sum())
            out = []
            for d in block:
                pick = np.nonzero(owner == d)[0]
                out.append(self._build_local_table(
                    up, int(t.dropped[smap[d]]), rkeys[pick], ts[pick],
                    dirty[pick], tree_map(lambda v: v[pick], vals)))
            tables[up.name] = _stack(out)
        return moved

    def _build_local_table(self, up, dropped0: int, in_keys, in_ts,
                           in_dirty, in_vals) -> tbl.SlateTable:
        """One shard's fresh table on the engine's device from migrated
        rows: duplicate keys (partials converging here) folded in
        first-seen order with the updater's combine, then inserted in
        chunks of 256 rows; rows flushed before the move stay clean."""
        combine = getattr(up, "combine", None)
        first: Dict[int, int] = {}
        in_ts, in_dirty = np.array(in_ts), np.array(in_dirty)
        leaves, spec = pytree.tree_flatten(tree_map(np.array, in_vals))
        row = lambda j: pytree.tree_unflatten(
            [torch.from_numpy(np.array(lf[j])) for lf in leaves], spec)
        for i, k in enumerate(in_keys.tolist()):
            if k in first:
                j = first[k]
                if combine is not None:
                    merged = pytree.tree_flatten(combine(row(j), row(i)))[0]
                else:
                    merged = pytree.tree_flatten(
                        row(i) if in_ts[i] >= in_ts[j] else row(j))[0]
                for lf, rw in zip(leaves, merged):
                    lf[j] = rw.numpy()
                in_ts[j] = max(in_ts[j], in_ts[i])
                in_dirty[j] = True
            else:
                first[k] = i
        uniq = np.asarray(sorted(first.values()), np.int64)
        dev = self.device
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        keys, ts = on(np.asarray(in_keys)[uniq]), on(in_ts[uniq])
        clean = on(~in_dirty[uniq])
        vals = pytree.tree_unflatten([on(lf[uniq]) for lf in leaves], spec)

        local = tbl.make_table(up.table_capacity, up.slate_spec(),
                               key_dtype=self.key_dtype, device=dev)
        drops = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(0, len(uniq), 256):
            k = keys[i:i + 256]
            local, slot, _, placed = tbl.insert_or_find(
                local, k, torch.ones(k.shape, dtype=torch.bool, device=dev))
            local = tbl.write_slates(
                local, slot, placed, tree_map(lambda v: v[i:i + 256], vals),
                ts[i:i + 256])
            # write_slates marks landed rows dirty; rows flushed before
            # the move stay clean (they still match the store)
            keep_clean = clean[i:i + 256] & placed
            tbl.fill_rows(local.dirty, torch.where(
                keep_clean, slot, local.capacity), False)
            drops = drops + (~placed).sum(dtype=torch.int32)
        local.dropped = drops + dropped0
        return local

    def _migrate_queues_host(self, queues, slot_map=None) -> Dict[str, int]:
        """Re-home queued events (what the drain barrier could not
        retire) through the new ring, rebuilding each queue compacted at
        head 0 in (source shard, dequeue order).  ``dropped`` carries;
        ``peak`` restarts at the new backlog.  Like the table migrator,
        the input may have more slices than ``self.n_shards``
        (compaction)."""
        moved: Dict[str, int] = {}
        n = self.n_shards
        smap = np.asarray(slot_map if slot_map is not None else range(n),
                          np.int64)
        for op in self.wf.operators:
            q = queues[op.name]
            sizes, heads = q.size, q.head
            cap = q.buf.key.shape[1] - 1            # the sink row aside
            moved[op.name] = 0
            old2new = np.full(len(sizes), -1, np.int64)
            old2new[smap] = np.arange(n)
            new_sizes = np.zeros(n, np.int32)
            new_drop = q.dropped[smap].copy()
            if int(sizes.sum()) == 0:
                queues[op.name] = q_mod.QueueState(
                    buf=tree_map(lambda x: x[smap], q.buf),
                    head=np.zeros(n, np.int32), size=new_sizes,
                    dropped=new_drop, peak=np.zeros(n, np.int32))
                continue
            fields, spec = pytree.tree_flatten(q.buf)
            src = np.concatenate([np.full(sizes[s], s, np.int64)
                                  for s in range(len(sizes))])
            at = np.concatenate([(heads[s] + np.arange(sizes[s])) % cap
                                 for s in range(len(sizes))]).astype(np.int64)
            cat = [f[src, at] for f in fields]
            dest = self.ring.owners(q.buf.key[src, at], _salt(op.name))
            moved[op.name] = int((dest != old2new[src]).sum())
            # rebuild each destination queue: stayers and movers, FIFO
            bufs = [np.zeros((n, cap + 1) + f.shape[2:], f.dtype)
                    for f in fields]
            for d in range(n):
                pick = np.nonzero(dest == d)[0]
                if len(pick) > cap:
                    new_drop[d] += len(pick) - cap
                    pick = pick[:cap]
                for b, c in zip(bufs, cat):
                    b[d, :len(pick)] = c[pick]
                new_sizes[d] = len(pick)
            queues[op.name] = q_mod.QueueState(
                buf=pytree.tree_unflatten(bufs, spec),
                head=np.zeros(n, np.int32), size=new_sizes,
                dropped=new_drop, peak=new_sizes.copy())
        return moved

    # ---- runtime hot-key splitting (DESIGN.md 13.4) ----
    def split_keys(self, state, keys):
        """Live hotspot relief for heavy-hitter keys (paper Example 6 at
        run time): register ``keys`` in the hot set so their events
        spread over the key's primary *and* secondary ring shard;
        ``read_slate`` merges the partials with the updater's combine.
        A content-only swap of a fixed-shape set, in effect from the
        next tick.  Returns ``(state, None)``; undo with
        :meth:`clear_split`."""
        if self._hot_capacity == 0:
            raise ValueError(
                "split_keys needs the hot-key split path in the tick: "
                "set DistConfig.hot_key_capacity > 0 together with "
                "cfg.telemetry, durability off")
        if self.dur is not None:
            raise ValueError(
                "split_keys requires durability off: per-key partials "
                "are not store-mergeable (the two_choice_threshold "
                "constraint)")
        if len(self.active_shards) < 2:
            return state, None
        cur = [int(k) for k, v in zip(self._hot_keys, self._hot_valid)
               if v]
        for k in keys:
            if int(k) not in cur:
                cur.append(int(k))
        # active splits keep priority: evicting one would strand its
        # partials (reads stop merging the secondary)
        cur = cur[:self._hot_capacity]
        hk = np.zeros_like(self._hot_keys)
        hv = np.zeros_like(self._hot_valid)
        hk[:len(cur)] = cur
        hv[:len(cur)] = True
        with self.read_lock:
            self._hot_keys, self._hot_valid = hk, hv
            self._hot_dev = None
            self._hot_table()
        return state, None

    def split_key_set(self) -> List[int]:
        """Currently split (hot) keys."""
        return [int(k) for k, v in zip(self._hot_keys, self._hot_valid)
                if v]

    def heat_owners(self, keys) -> np.ndarray:
        """Ring owner per key per updater, ``[n_updaters, K]`` (routing
        is salted by destination, so a key heavy for two updaters heats
        two shards)."""
        ups = list(self.wf.updaters())
        ks = np.asarray(keys, np.int64 if self.key_bits == 64
                        else np.int32)
        if not ups:
            return np.zeros((1, len(ks)), np.int32)
        return np.stack([self.ring.owners(ks, _salt(u.name))
                         for u in ups])

    # ---- introspection ----
    def stats(self, state) -> Dict[str, Any]:
        """Whole-engine counters; over ranks every rank's ``[n_local]``
        counters are gathered (one collective), so every rank returns
        the same dict."""
        tree = all_gather_tree({
            "tick": state["tick"],
            "exchange_dropped": state["exchange_dropped"],
            "throttle_hits": state["throttle_hits"],
            "deferred": state["deferred"],
            "processed": dict(state["processed"]),
            "queue_dropped": {k: q.dropped
                              for k, q in state["queues"].items()},
            "table_occupancy": {k: t.occupancy()
                                for k, t in state["tables"].items()},
        }, self.group)
        g = lambda x: x.cpu().numpy()
        return {
            "tick": int(g(tree["tick"]).max()),
            "exchange_dropped": int(g(tree["exchange_dropped"]).sum()),
            "throttle_hits": int(g(tree["throttle_hits"]).sum()),
            "deferred": int(g(tree["deferred"]).sum()),
            "processed": {k: int(g(v).sum())
                          for k, v in tree["processed"].items()},
            "queue_dropped": {k: int(g(v).sum())
                              for k, v in tree["queue_dropped"].items()},
            "table_occupancy": {k: int(g(v).sum())
                                for k, v in tree["table_occupancy"].items()},
        }

    def gather_tree(self, tree):
        """A tree of ``[n_local, ...]`` leaves as ``[n_shards, ...]``, every
        rank's block gathered (one collective; the tree itself without a
        group).  The telemetry registry reads its boundary signals
        through this."""
        return all_gather_tree(tree, self.group)

    def _query(self, keys) -> np.ndarray:
        return np.asarray(keys, np.int64 if self.key_bits == 64
                          else np.int32).reshape(-1)

    def read_slate(self, state, updater: str, key: int, *, merge=None):
        """Read a slate by key (dict of host tensors, or ``None``); with
        two-choice on — or the key in the hot-key split set — merges the
        (at most two) partials, primary then secondary, with the
        updater's combine.  Holds ``read_lock``."""
        with self.read_lock:
            karr = torch.from_numpy(self._query([key]))
            rh, rs = self.ring.table()
            salt = _salt(updater)
            shards = [int(route(karr, salt, rh, rs)[0])]
            is_hot = bool(np.any(self._hot_valid & (self._hot_keys == key)))
            if self.cfg.two_choice_threshold or is_hot:
                shards.append(int(route_secondary(karr, salt, rh, rs)[0]))
            vals = self._read_rows(state["tables"][updater],
                                   karr.to(self.device),
                                   list(dict.fromkeys(shards)))
        if not vals:
            return None
        out = vals[0]
        if len(vals) > 1:
            combine = merge or self.wf.by_name[updater].combine
            for v in vals[1:]:
                out = combine(out, v)
        return out

    def _read_rows(self, t: tbl.SlateTable, q: torch.Tensor,
                   shards: List[int]):
        """``read_slate``'s lookups: the rank holding each of ``shards``
        looks the key up (one ``lookup_slots`` a shard), one
        ``all_gather`` over a group brings every rank the hit flags and
        rows, and the holder's are taken.  Returns the found rows in
        ``shards``' order, on the host."""
        k = len(shards)
        found = torch.zeros(k, dtype=torch.bool, device=self.device)
        leaves, spec = pytree.tree_flatten(t.vals)
        rows = [torch.zeros((k,) + tuple(v.shape[2:]), dtype=v.dtype,
                            device=self.device) for v in leaves]
        for j, s in enumerate(shards):
            i = s - self.shard_lo
            if not 0 <= i < self.n_local:
                continue
            local = _row(t, i)
            slot, hit = lk_ops.lookup_slots(local.keys, q, local.capacity)
            at = torch.where(hit[0], slot[0], local.capacity).long()
            found[j] = hit[0]
            for r, v in zip(rows, leaves):
                r[j] = v[i, at]
        found, *rows = all_gather_rows([found, *rows], self.group)
        out = []
        for j, s in enumerate(shards):
            g = (s // self.n_local) * k + j
            if bool(found[g].item()):
                out.append(pytree.tree_unflatten(
                    [r[g].to("cpu", copy=True) for r in rows], spec))
        return out

    def read_slates(self, state, updater: str, keys, *,
                    impl: str = "auto"):
        """Batched point reads through the ring: one lookup a shard over
        the whole ``[Q]`` key vector, each hit tagged with the ring roles
        its shard holds for the key (bit 1 primary, bit 2 effective
        secondary), the partials stacked (the JAX package's
        ``all_gather``) and copied to the host once; the host picks the
        owner's row per (key, role).  Bitwise equal to Q ``read_slate``
        calls.  Returns a list aligned with ``keys`` (``None`` for
        missing)."""
        keys_np = self._query(keys)
        if keys_np.size == 0:
            return []
        with self.read_lock:
            with_sec = (bool(self.cfg.two_choice_threshold)
                        or bool(self._hot_valid.any()))
            rh, rs = self.ring.table(self.device)
            q = torch.from_numpy(keys_np).to(self.device)
            salt = _salt(updater)
            prim = route(q, salt, rh, rs)
            if with_sec:
                sec = route_secondary(q, salt, rh, rs)
                hk, hv = self._hot_table()
                is_hot = ((q[:, None] == hk) & hv).any(-1)
                use_sec = (bool(self.cfg.two_choice_threshold)
                           | is_hot) & (sec != prim)
                sec_eff = torch.where(use_sec, sec, -1)
            t = state["tables"][updater]
            masks, rows = [], []
            for i in range(self.n_local):
                s = self.shard_lo + i
                local = _row(t, i)
                found, r = lk_ops.lookup_tree(local.keys, local.vals, q,
                                              impl=impl,
                                              capacity=local.capacity)
                m = (found & (prim == s)).to(torch.int32)
                if with_sec:
                    m = m | ((found & (sec_eff == s)).to(torch.int32) << 1)
                masks.append(m)
                rows.append(r)
            # every rank's partials, gathered once (the JAX package's
            # all_gather); stacked as they are on one card
            mask, rows = all_gather_tree(
                (torch.stack(masks), tree_map(lambda *xs: torch.stack(xs),
                                              *rows)), self.group)
            mask = mask.cpu().numpy()
            rows = tree_map(lambda x: x.cpu(), rows)
        qi = np.arange(keys_np.size)
        pm = (mask & 1).astype(bool)                    # [n_shards, Q]
        pf, psh = pm.any(axis=0), pm.argmax(axis=0)
        pr = tree_map(lambda v: v[psh, qi], rows)
        if with_sec:
            sm = (mask & 2).astype(bool)
            sf, ssh = sm.any(axis=0), sm.argmax(axis=0)
            sr = tree_map(lambda v: v[ssh, qi], rows)
        else:
            sf, sr = np.zeros_like(pf), None
        combine = getattr(self.wf.by_name[updater], "combine", None)
        out = []
        for i in range(keys_np.size):
            a = tree_map(lambda v: v[i], pr) if pf[i] else None
            b = tree_map(lambda v: v[i], sr) if sr is not None and sf[i] \
                else None
            if a is not None and b is not None:
                out.append(combine(a, b))
            else:
                out.append(a if a is not None else b)
        return out
