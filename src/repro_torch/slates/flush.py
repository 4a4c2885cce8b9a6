"""Slate table <-> KV store synchronization (port of
``repro.slates.flush``).

Implements the paper's flush knob ("immediate write-through" ...
"only when evicted from cache"), background-thread flushing (the Muppet
2.0 background-I/O thread, so the update loop never blocks on the
store), read-through restore after a crash, and the *flush frontier*
(DESIGN.md section 10): the durable ``(tick, wal_offset)`` watermark
from which WAL replay resumes after recovery.

A snapshot is taken in two halves (DESIGN.md section 17.2).  The port's
tick updates tables in place, so :func:`begin_dirty_snapshot` clones
``dirty``, ``keys``, ``ts`` and ``vals`` on the device, on the stream
that runs the ticks, before the next chunk is issued, then clears
``dirty`` in place.  :func:`finish_dirty_snapshot` runs after the next
chunk has been issued: on a CUDA device it compacts the clones to the
dirty rows (``nonzero`` and a gather) and copies them into pinned host
memory on a second stream, which waits only on an event recorded at
``begin``, so the host never waits for the next chunk.  A snapshot
covers rows ``[:C]`` only: the sink row ``C`` takes the masked writes of
losing insert claimants and may hold a real key with ``dirty`` set.
"""
from __future__ import annotations

import enum
import json
import os
import queue as pyqueue
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.event import (flatten_sorted, tree_map,
                                    unflatten_sorted)
from repro_torch.slates import table as tbl
from repro_torch.slates.kvstore import KVStore


class FlushPolicy(enum.Enum):
    IMMEDIATE = "immediate"    # write-through every tick
    EVERY_K = "every_k"        # every k ticks
    ON_EVICT = "on_evict"      # only under table pressure / TTL expiry


@dataclass
class FlushConfig:
    policy: FlushPolicy = FlushPolicy.EVERY_K
    every_k: int = 16
    occupancy_evict: float = 0.85   # ON_EVICT pressure threshold


class FlushError(RuntimeError):
    """One or more background flush writes failed; ``.errors`` holds the
    underlying exceptions in arrival order."""

    def __init__(self, errors: Sequence[BaseException]):
        self.errors = list(errors)
        super().__init__(
            f"{len(self.errors)} flush write(s) failed: "
            f"{self.errors[0]!r}")


# ---------------------------------------------------------------------------
# flush frontier: the durable replay watermark
# ---------------------------------------------------------------------------

@dataclass
class FlushFrontier:
    """Everything before ``tick`` / ``wal_offset`` is durably reflected
    in the KV store; recovery restores slates and replays the WAL from
    here.  ``wal_offset`` is an int (single shard) or a per-shard list
    (one WAL per shard, one barrier tick).  ``meta`` is an opaque
    json-serializable driver cursor (e.g. the source index at the
    boundary) that survives even full WAL truncation."""

    tick: int = 0
    wal_offset: Union[int, List[int]] = 0
    meta: Optional[dict] = None

    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"tick": int(self.tick),
                       "wal_offset": self.wal_offset,
                       "meta": self.meta}, f)
        os.replace(tmp, path)   # atomic: a crash mid-save keeps the old
                                # frontier, replay just covers more ticks

    @staticmethod
    def load(path: str) -> Optional["FlushFrontier"]:
        if not os.path.exists(path):
            return None
        with open(path) as f:
            d = json.load(f)
        return FlushFrontier(tick=int(d["tick"]),
                             wal_offset=d["wal_offset"],
                             meta=d.get("meta"))


@dataclass
class SnapshotToken:
    """A snapshot begun and not yet resolved: device clones of rows
    ``[:C]`` and, on a CUDA device, the event recorded after them."""
    dirty: torch.Tensor
    keys: torch.Tensor
    ts: torch.Tensor
    vals: object
    event: Optional[torch.cuda.Event] = None


def begin_dirty_snapshot(table: tbl.SlateTable) -> SnapshotToken:
    """Start a flush snapshot: clone rows ``[:C]`` of ``dirty``, ``keys``,
    ``ts`` and every value leaf on the device (issued on the current
    stream, ahead of any later tick), then clear ``dirty`` in place.
    Returns the token for :func:`finish_dirty_snapshot`; the table is
    usable at once."""
    C = table.capacity
    token = SnapshotToken(
        dirty=table.dirty[:C].clone(), keys=table.keys[:C].clone(),
        ts=table.ts[:C].clone(),
        vals=tree_map(lambda v: v[:C].clone(), table.vals))
    table.dirty.zero_()
    if table.keys.is_cuda:
        token.event = torch.cuda.Event()
        token.event.record()
    return token


def finish_dirty_snapshot(token: SnapshotToken):
    """Resolve a snapshot to host ``(keys, ts, vals)`` numpy arrays of
    its dirty occupied rows (the flusher's row format).  On a CUDA device
    the compaction and the copy run on a second stream behind the
    token's event, so they never wait for ticks issued after ``begin``."""
    if token.event is None:
        idx = torch.nonzero(token.dirty & (token.keys != tbl.EMPTY))[:, 0]
        host = lambda t: t[idx].numpy()
        return host(token.keys), host(token.ts), tree_map(host, token.vals)
    side = torch.cuda.Stream(device=token.keys.device)
    with torch.cuda.stream(side):
        side.wait_event(token.event)
        clones = [token.dirty, token.keys, token.ts,
                  *flatten_sorted(token.vals)[0]]
        for t in clones:
            # the clones were allocated on the tick stream: keep their
            # memory from being reused there while this stream reads it
            t.record_stream(side)
        idx = torch.nonzero(token.dirty & (token.keys != tbl.EMPTY))[:, 0]

        def host(t):
            rows = t[idx]
            out = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            out.copy_(rows, non_blocking=True)
            return out

        keys, ts, vals = host(token.keys), host(token.ts), \
            tree_map(host, token.vals)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    return keys.numpy(), ts.numpy(), tree_map(lambda t: t.numpy(), vals)


def dirty_snapshot(table: tbl.SlateTable):
    """Host copies of (keys, ts, slates) for dirty slots, and the cleared
    table — the synchronous begin+finish composition; serialization and
    disk I/O still run on the flusher thread."""
    keys, ts, vals = finish_dirty_snapshot(begin_dirty_snapshot(table))
    return keys, ts, vals, table


def restore_into(table: tbl.SlateTable, keys: np.ndarray, slates,
                 ts: np.ndarray) -> tbl.SlateTable:
    """Re-insert flushed slates after a crash (read-through warm-up).

    ``ts`` is per-key (each slate's last-update tick, as recorded by the
    store): restoring per-slot timestamps keeps TTL eviction after
    recovery identical to the pre-crash schedule.  Idempotent: keys
    already present are overwritten, not merged, so a crash *during*
    recovery just means recovering again from the same frontier.  Keys
    are placed through ``insert_or_find`` (on a CUDA table each round's
    walk is the lookup kernel's ``find`` route); the rows come back
    clean (they came *from* the store).
    """
    if len(keys) == 0:
        return table
    dev = table.keys.device
    k = torch.as_tensor(np.asarray(keys)).to(dev, table.keys.dtype)
    valid = torch.ones(k.shape[0], dtype=torch.bool, device=dev)
    table, slot, found, placed = tbl.insert_or_find(table, k, valid)
    vals = tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(dev),
                    slates)
    table = tbl.write_slates(
        table, slot, placed, vals,
        torch.as_tensor(np.asarray(ts, np.int32)).to(dev))
    table.dirty.zero_()
    return table


class Flusher:
    """Background flusher thread: consumes dirty snapshots, writes to the
    KV store.  ``flush_table`` is called from the engine driver per the
    policy; ``drain`` joins outstanding work (flush barriers / shutdown)
    and **re-raises** any write error as :class:`FlushError` — a frontier
    must never advance past a failed store write.

    With ``track_deltas`` the flusher also keeps a host copy of every
    row it wrote since the last ``drain_deltas()`` call — the flush
    *stream* a :class:`~repro_torch.slates.replica.SlateReplica` consumes
    to refresh incrementally instead of re-scanning the whole store
    (DESIGN.md section 15)."""

    def __init__(self, store: KVStore, cfg: Optional[FlushConfig] = None,
                 *, track_deltas: bool = False):
        self.store = store
        self.cfg = cfg or FlushConfig()
        self.track_deltas = track_deltas
        self._deltas: dict = {}          # updater -> {key: (ts, slate)}
        self._dlock = threading.Lock()
        self._q: pyqueue.Queue = pyqueue.Queue()
        self.errors: list = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                updater, keys, ts, vals, ttl = item
                self.store.put_rows(updater, keys, vals, ts=ts, ttl=ttl)
                self.store.flush()
                if self.track_deltas:
                    # recorded only after the write landed: a delta the
                    # replica merges is always durably in the store too
                    rows = _rows_of(vals, len(keys))
                    with self._dlock:
                        d = self._deltas.setdefault(updater, {})
                        for k, t, row in zip(keys.tolist(), ts.tolist(),
                                             rows):
                            old = d.get(k)
                            if old is None or old[0] <= t:
                                d[k] = (t, row)
            except Exception as e:   # surfaced by drain(), never lost
                self.errors.append(e)
            finally:
                self._q.task_done()

    def drain_deltas(self) -> dict:
        """Hand off (and clear) the rows written since the last call:
        ``{updater: {key: (ts, slate)}}``, newest write per key.  Call
        after ``drain()`` (a flush barrier) so the handoff covers every
        row at the frontier."""
        with self._dlock:
            d, self._deltas = self._deltas, {}
        return d

    def should_flush(self, tick: int, table: tbl.SlateTable) -> bool:
        p = self.cfg.policy
        if p is FlushPolicy.IMMEDIATE:
            return True
        if p is FlushPolicy.EVERY_K:
            return tick % self.cfg.every_k == 0
        occ = int(table.occupancy().item())
        return occ >= self.cfg.occupancy_evict * table.capacity

    def flush_rows(self, updater: str, keys: np.ndarray, ts: np.ndarray,
                   vals, ttl: int = 0):
        """Enqueue host rows already snapshotted.  Store write ticks are
        the per-row ``ts`` (each slate's last-update tick)."""
        if len(keys):
            self._q.put((updater, np.asarray(keys), np.asarray(ts), vals,
                         ttl))

    def flush_table(self, updater: str, table: tbl.SlateTable,
                    ttl: int = 0) -> tbl.SlateTable:
        keys, ts, vals, cleared = dirty_snapshot(table)
        self.flush_rows(updater, keys, ts, vals, ttl)
        return cleared

    def _raise_accumulated(self):
        if self.errors:
            errs, self.errors = self.errors, []
            raise FlushError(errs)

    def drain(self):
        """Join outstanding writes; raises :class:`FlushError` if any
        failed (callers must not record a frontier past the failure)."""
        self._q.join()
        try:
            self.store.flush()
        except Exception as e:   # a failed write of the store's buffer
            self.errors.append(e)
        self._raise_accumulated()

    def close(self):
        try:
            self.drain()
        finally:
            self._q.put(None)
            self._thread.join(timeout=5)


def _rows_of(vals, n: int) -> List[dict]:
    """Split a pytree of [n, ...] arrays into n per-key pytrees, each
    leaf walked once along its leading axis."""
    leaves, structure = flatten_sorted(vals)
    if not leaves:
        return [unflatten_sorted(structure, []) for _ in range(n)]
    per_leaf = [list(lf) for lf in leaves]
    kind, names, children = structure or (None, None, ())
    if kind == "dict" and all(c is None for c in children):
        # a flat dict of arrays (the common slate): no tree rebuild a row
        return [dict(zip(names, row)) for row in zip(*per_leaf)]
    return [unflatten_sorted(structure, list(row)) for row in zip(*per_leaf)]
