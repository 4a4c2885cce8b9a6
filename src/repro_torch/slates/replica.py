"""Read-replica tier and hot-key cache (port of
``repro.slates.replica``, DESIGN.md section 15).

The engine-attached read path (``read_slate`` / ``read_slates``)
answers from the live device tables — up to date, but every request
contends with the stream for the device.  Two off-engine tiers:

- :class:`SlateReplica` consumes the *flush stream* the durability
  runtime already produces: at every flush frontier the KV store holds
  a consistent snapshot of all flushed slates, so a replica can
  ``refresh()`` itself from the store (or from the flusher's deltas)
  and serve reads without touching engine state.  Staleness is bounded:
  a replica knows the frontier tick of its snapshot and refuses reads
  whose ``now`` has drifted more than ``max_staleness_ticks`` past it
  (:class:`StaleReplicaError`).
- :class:`HotKeyCache` fronts the live read path (``StateHandle``) for
  the keys the count-min telemetry sketch reports as heavy hitters: the
  run loop warms the admission set from each window's
  ``heavy_hitters`` and invalidates whole-sale whenever the flush
  frontier advances.  A bounded LRU with optional wall-clock TTL; only
  admitted (hot) keys are stored, so one scan of cold keys cannot
  evict the working set.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.slates.flush import FlushFrontier, _rows_of


class StaleReplicaError(RuntimeError):
    """The replica's snapshot is older than the read's staleness bound."""

    def __init__(self, snapshot_tick: int, now: int, bound: int):
        self.snapshot_tick = snapshot_tick
        self.now = now
        self.bound = bound
        super().__init__(
            f"replica snapshot at tick {snapshot_tick} is "
            f"{now - snapshot_tick} ticks behind now={now} "
            f"(max_staleness_ticks={bound})")


class HotKeyCache:
    """LRU/TTL cache admitting only telemetry-designated hot keys.

    ``warm(keys)`` swaps the admission set (the window's heavy
    hitters); ``put`` silently drops non-admitted keys.  ``get``
    returns ``(hit, value)`` so a cached ``None``-free design stays
    simple: misses and cold keys look identical to the caller, which
    falls through to the live read.  ``invalidate()`` clears entries
    but keeps the admission set (the keys are still hot; their values
    are merely suspect after a frontier advance).  Thread-safe.
    """

    def __init__(self, capacity: int = 256,
                 ttl_s: Optional[float] = None,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._clock = clock
        self._hot: set = set()
        self._entries: "OrderedDict[Tuple[str, int], Tuple[float, Any]]" \
            = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def warm(self, keys: Iterable[int]):
        """Replace the admission set with this window's heavy hitters."""
        with self._lock:
            self._hot = {int(k) for k in keys}

    def hot_keys(self) -> List[int]:
        with self._lock:
            return sorted(self._hot)

    def get(self, updater: str, key: int) -> Tuple[bool, Any]:
        k = (updater, int(key))
        with self._lock:
            ent = self._entries.get(k)
            if ent is not None:
                stamp, val = ent
                if self.ttl_s is None or \
                        self._clock() - stamp <= self.ttl_s:
                    self._entries.move_to_end(k)
                    self.hits += 1
                    return True, val
                del self._entries[k]        # TTL-expired
            self.misses += 1
            return False, None

    def put(self, updater: str, key: int, value: Any):
        with self._lock:
            if int(key) not in self._hot:
                return
            self._entries[(updater, int(key))] = (self._clock(), value)
            self._entries.move_to_end((updater, int(key)))
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def invalidate(self):
        """Drop every cached value (flush frontier advanced)."""
        with self._lock:
            if self._entries:
                self.invalidations += 1
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "hot_keys": len(self._hot),
                    "hits": self.hits, "misses": self.misses,
                    "invalidations": self.invalidations}


class SlateReplica:
    """Stale-bounded slate reads from flush-frontier snapshots.

    ``workflow`` names the updaters (and their TTLs) to snapshot;
    ``store`` is the KV store the engine's flusher writes.  A replica
    never touches engine device state — it can run in another process
    against the same store directory.  Thread-safe: ``refresh`` swaps
    the snapshot dict atomically under a lock.
    """

    def __init__(self, store, workflow, *,
                 max_staleness_ticks: int = 64, flusher=None):
        if max_staleness_ticks < 0:
            raise ValueError("max_staleness_ticks must be >= 0")
        self.store = store
        self.wf = workflow
        self.max_staleness_ticks = max_staleness_ticks
        # a delta-tracking Flusher: refresh merges its flush stream
        # instead of re-scanning the store (first refresh still scans)
        self.flusher = flusher
        self._snap: Dict[str, Dict[int, tuple]] = {}
        self._tick = -1                      # no snapshot yet
        self._lock = threading.Lock()

    @property
    def snapshot_tick(self) -> int:
        """Frontier tick of the current snapshot (-1 before the first
        ``refresh``)."""
        with self._lock:
            return self._tick

    def refresh(self, frontier: Optional[FlushFrontier] = None, *,
                tick: Optional[int] = None) -> int:
        """Re-snapshot every updater's flushed slates at a frontier.

        Pass the engine's ``FlushFrontier`` (or an explicit ``tick``
        when driving from a raw store).  TTL-bearing updaters are
        scanned with ``now=tick`` so rows the engine would have expired
        never enter the snapshot.  Returns the number of rows held.

        With a delta-tracking ``flusher`` attached, refreshes after the
        first merge the flush stream (``drain_deltas``) into the held
        snapshot — newest write tick wins, TTL-expired rows are pruned
        — instead of re-reading every store segment; byte-for-byte the
        same snapshot a full scan at the frontier would build (the
        store applies the identical newest-wins rule at merge time).
        Call at flush barriers (after ``Flusher.drain``) so the delta
        handoff is complete at the frontier.
        """
        if tick is None:
            tick = int(frontier.tick) if frontier is not None else 0
        deltas = self.flusher.drain_deltas() \
            if self.flusher is not None else {}
        with self._lock:
            base, base_tick = self._snap, self._tick
        snap: Dict[str, Dict[int, tuple]] = {}
        rows = 0
        for up in self.wf.updaters():
            if self.flusher is None or base_tick < 0:
                # cold start (or no flush stream): full store scan;
                # drained deltas are already reflected in the scan
                cur = self._scan(up.name, now=tick if up.ttl else None)
            else:
                cur = dict(base.get(up.name, {}))
                for k, rec in deltas.get(up.name, {}).items():
                    old = cur.get(k)
                    if old is None or old[0] <= rec[0]:
                        cur[k] = rec
                if up.ttl:
                    cur = {k: rec for k, rec in cur.items()
                           if tick - rec[0] <= up.ttl}
            snap[up.name] = cur
            rows += len(cur)
        with self._lock:
            self._snap = snap
            self._tick = int(tick)
        return rows

    def _scan(self, updater: str, now: Optional[int]):
        """``store.scan_records`` through the store's batched
        ``scan_rows``: ``{key: (ts, slate)}``."""
        rows = self.store.scan_rows(updater, now=now)
        if rows is None:
            return {}
        keys, ts, slates = rows
        return dict(zip(keys.tolist(), zip(ts.tolist(),
                                           _rows_of(slates, len(keys)))))

    def _check_staleness(self, now: Optional[int], tick: int):
        if tick < 0:
            raise StaleReplicaError(tick, now if now is not None else 0,
                                    self.max_staleness_ticks)
        if now is not None and now - tick > self.max_staleness_ticks:
            raise StaleReplicaError(tick, now, self.max_staleness_ticks)

    def read(self, updater: str, key: int,
             now: Optional[int] = None):
        """One slate from the snapshot; ``now`` (the caller's engine
        tick) enforces the staleness bound — omit it for bound-free
        reads.  Returns ``None`` for missing keys."""
        with self._lock:
            tick, snap = self._tick, self._snap
        self._check_staleness(now, tick)
        rec = snap.get(updater, {}).get(int(key))
        return rec[1] if rec is not None else None

    def read_many(self, updater: str, keys,
                  now: Optional[int] = None) -> List[Any]:
        """Batched snapshot reads, list aligned with ``keys``."""
        with self._lock:
            tick, snap = self._tick, self._snap
        self._check_staleness(now, tick)
        table = snap.get(updater, {})
        out = []
        for k in keys:
            rec = table.get(int(k))
            out.append(rec[1] if rec is not None else None)
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"snapshot_tick": self._tick,
                    "max_staleness_ticks": self.max_staleness_ticks,
                    "rows": {u: len(t) for u, t in self._snap.items()}}

    def serve(self, port: int = 0):
        """HTTP server over the replica (the live read path's
        :class:`~repro_torch.slates.http.SlateServer` surface)."""
        from repro_torch.slates.http import SlateServer
        return SlateServer(
            read_fn=self.read, stats_fn=self.stats,
            read_many_fn=lambda up, ks: self.read_many(up, ks),
            port=port)
