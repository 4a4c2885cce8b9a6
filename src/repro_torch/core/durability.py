"""Durability layer threaded through the engine driver (DESIGN.md 10;
port of ``repro.core.durability``).

Muppet keeps slates recoverable by continuously flushing them to
Cassandra and restoring on restart (paper sections 4.2-4.3); event
replay is the paper's stated future work.  This module wires both into
one runtime:

- every ingested source batch is appended to a per-shard
  :class:`~repro_torch.slates.wal.WriteAheadLog` *before* the tick that
  consumes it (write-ahead);
- per :class:`~repro_torch.slates.flush.FlushPolicy`, every updater's
  :class:`~repro_torch.slates.table.SlateTable` is flushed to the
  :class:`~repro_torch.slates.kvstore.KVStore` and a
  :class:`~repro_torch.slates.flush.FlushFrontier` ``(tick,
  wal_offset)`` is recorded atomically once the writes are durable;
- recovery = restore flushed slates + replay the WAL suffix from the
  frontier through the same chunk path.

On a CUDA device an append does not wait for the card: it issues a
copy of the tick's source batches into pinned host memory on the stream
that runs the ticks (so no later tick can overwrite them first) and
records an event; the writer thread waits on the event, then encodes
and writes.  On the CPU the batches are cloned.

Guarantees (see DESIGN.md section 10 for the full table): with the
default drain **barrier** the pipeline is empty at every frontier, so
replay applies each surviving event exactly once — bitwise-identical
slates for associative updaters.  With ``barrier=False`` the frontier is
set ``replay_slack`` ticks behind the flush, which re-applies in-flight
events already captured by the snapshot: *at-least-once*, acceptable for
idempotent sequential updaters (e.g. last-value), wrong for counters.
"""
from __future__ import annotations

import functools
import os
import queue as pyqueue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.event import tree_map
from repro_torch.slates.flush import (FlushConfig, Flusher, FlushFrontier,
                                      FlushPolicy)
from repro_torch.slates.kvstore import KVStore
from repro_torch.slates.wal import WriteAheadLog


@dataclass
class DurabilityConfig:
    """Pure configuration (paths + knobs) — runtime handles live in
    :class:`EngineDurability` so configs stay copyable/shareable."""

    dir: str                          # root: wal(s), store, FRONTIER.json
    flush: FlushConfig = field(default_factory=FlushConfig)
    # drain in-flight queues before each flush: exactly-once replay.
    # False skips the drain ticks and backdates the frontier by
    # replay_slack: at-least-once replay (see module docstring).
    barrier: bool = True
    drain_ticks_max: int = 64
    replay_slack: Optional[int] = None   # None = auto from workflow shape
    truncate_wal: bool = False        # compact the log at each frontier
    sync_wal: bool = False            # fsync every append
    # KV store replication (1 replica: plain local dir; >1 simulates the
    # paper's Cassandra quorum cluster)
    replicas: int = 1
    write_quorum: int = 1
    read_quorum: int = 1
    # retain flushed rows host-side (Flusher.track_deltas) so an
    # attached SlateReplica can refresh incrementally from the flush
    # stream instead of re-scanning the store (DESIGN.md section 15)
    track_flush_deltas: bool = False

    def store_root(self) -> str:
        return os.path.join(self.dir, "store")

    def wal_path(self, shard: Optional[int] = None) -> str:
        if shard is None:
            return os.path.join(self.dir, "wal.log")
        return os.path.join(self.dir, f"shard_{shard:03d}", "wal.log")

    def frontier_path(self) -> str:
        return os.path.join(self.dir, "FRONTIER.json")

    def make_store(self) -> KVStore:
        return KVStore(self.store_root(), replicas=self.replicas,
                       write_quorum=self.write_quorum,
                       read_quorum=self.read_quorum)


class WALAppendError(RuntimeError):
    """One or more background WAL appends failed; ``.errors`` holds the
    underlying exceptions in arrival order.  Raised at the next fence —
    a frontier must never advance past a failed append."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__(
            f"{len(self.errors)} WAL append(s) failed: "
            f"{self.errors[0]!r}")


def auto_replay_slack(workflow, queue_capacity: int,
                      batch_size: int) -> int:
    """Sound residence bound for barrier-less frontiers: an event sits at
    most ceil(Q/B) ticks per hop (bounded FIFO draining B per tick), for
    at most graph-depth hops.  Sustained hotspot deferral past this bound
    voids the guarantee — use the barrier (DESIGN.md 10.3)."""
    depth = max(1, len(workflow.operators))
    per_hop = -(-queue_capacity // max(1, batch_size))   # ceil
    return depth * (1 + per_hop) + 1


class EngineDurability:
    """Runtime durability state for one engine (or one shard group).

    Owns the WAL(s), the KV store + background flusher, and the frontier
    file.  ``n_shards=None`` is the single-shard engine (one WAL);
    an int opens one WAL per shard sharing a single store + frontier
    barrier (each shard's offset tracked independently).  ``first``:
    the global index of the first of those shards — a rank of a
    multi-rank engine opens only its own block's WALs, ``wals[i]`` being
    shard ``first + i``'s.
    """

    def __init__(self, cfg: DurabilityConfig, workflow,
                 queue_capacity: int, batch_size: int,
                 n_shards: Optional[int] = None, first: int = 0):
        self.cfg = cfg
        self.wf = workflow
        self.n_shards = n_shards
        self.first = first
        os.makedirs(cfg.dir, exist_ok=True)
        self.store = cfg.make_store()
        self.flusher = Flusher(self.store, cfg.flush,
                               track_deltas=cfg.track_flush_deltas)
        if n_shards is None:
            self.wals = [WriteAheadLog(cfg.wal_path(), sync=cfg.sync_wal)]
        else:
            self.wals = [WriteAheadLog(cfg.wal_path(first + s),
                                       sync=cfg.sync_wal)
                         for s in range(n_shards)]
        self.frontier = FlushFrontier.load(cfg.frontier_path()) or \
            FlushFrontier(tick=0, wal_offset=self._offsets())
        self.slack = cfg.replay_slack if cfg.replay_slack is not None \
            else auto_replay_slack(workflow, queue_capacity, batch_size)
        # tick -> per-wal offsets *before* that tick's appends; needed to
        # backdate barrier-less frontiers.  Pruned against the frontier.
        # Touched only by the writer thread and by post-fence frontier
        # code (the fence empties the queue first), so no lock is needed.
        self._tick_offsets: Dict[int, List[int]] = {}
        # Async appender (DESIGN.md 17): the driver enqueues append
        # thunks and returns immediately; the wait for each append's host
        # copy and the file I/O run here, off the tick critical path.
        # Bounded so a slow disk exerts backpressure instead of growing
        # an unbounded backlog.
        self._wq: pyqueue.Queue = pyqueue.Queue(maxsize=64)
        self._werrs: list = []
        self._wthread = threading.Thread(target=self._writer_loop,
                                         daemon=True)
        self._wthread.start()

    @property
    def wal(self) -> WriteAheadLog:
        if self.n_shards is not None:
            raise AttributeError("per-shard WALs: use .wals[s]")
        return self.wals[0]

    def _offsets(self) -> List[int]:
        return [w.offset for w in self.wals]

    # ---- write-ahead ----
    def _writer_loop(self):
        while True:
            job = self._wq.get()
            if job is None:
                self._wq.task_done()
                return
            try:
                job()
            except Exception as e:   # surfaced by fence(), never lost
                self._werrs.append(e)
            finally:
                self._wq.task_done()

    def _do_append(self, tick: int, sources, shard: int):
        # writer-thread body: the synchronous append
        if not self.cfg.barrier:
            # barrier-less frontiers backdate by replay_slack ticks, so
            # only a sliding window of pre-append offsets is needed
            self._tick_offsets.setdefault(tick, self._offsets())
            for t in [t for t in self._tick_offsets
                      if t < tick - 2 * self.slack]:
                del self._tick_offsets[t]
        if sources:
            self.wals[shard].append(tick, sources)

    def _append_staged(self, tick: int, staged, event, shard: int):
        if event is not None:
            event.synchronize()      # the host copies have landed
        self._do_append(tick, staged, shard)

    def append(self, tick: int, sources, shard: Optional[int] = None):
        """Log one tick's sources (single-shard) or one shard's slice.

        Asynchronous: the batches' host copies are issued (see
        :func:`stage_sources`) and the append is handed to the
        background writer; this call returns at once — the write-ahead
        invariant is restored at :meth:`begin_frontier`, whose fence
        guarantees every append at or before the frontier tick is on disk
        before the frontier can cover it (DESIGN.md 17).  Blocks only
        when the bounded writer queue is full (slow-disk backpressure)."""
        staged, event = stage_sources(sources)
        self._wq.put(functools.partial(
            self._append_staged, int(tick), staged, event,
            0 if shard is None else int(shard)))

    def append_deferred(self, fn: Callable[[], None]):
        """Enqueue an arbitrary thunk on the writer thread — a
        multi-shard driver uses this to move the host copy of its
        per-shard source slices off the dispatch path; the thunk calls
        :meth:`_do_append` per shard itself.  Ordering with respect to
        plain :meth:`append` calls is FIFO (one queue, one writer)."""
        self._wq.put(fn)

    def fence(self):
        """Epoch fence: wait until every enqueued append has hit the
        WAL, then re-raise any writer error as :class:`WALAppendError`.
        After the fence the writer queue is empty, so ``_tick_offsets``
        and the WAL offsets may be read from the driver thread."""
        self._wq.join()
        if self._werrs:
            errs, self._werrs = self._werrs, []
            raise WALAppendError(errs)

    # ---- frontier ----
    def due(self, tick: int, tables=None) -> bool:
        """Flush decision at a chunk boundary.  EVERY_K fires when the
        boundary crossed a multiple of k since the last frontier."""
        p = self.cfg.flush.policy
        if p is FlushPolicy.IMMEDIATE:
            return tick > self.frontier.tick
        if p is FlushPolicy.EVERY_K:
            k = self.cfg.flush.every_k
            return tick // k > self.frontier.tick // k
        if tables is None:
            return False
        return any(self.flusher.should_flush(tick, t)
                   for t in tables.values())

    def begin_frontier(self, tick: int):
        """Phase one of a frontier advance: fence the async writer (so
        every append the new frontier must cover is on disk and the
        offset maps are stable), then capture the replay point.  Returns
        an opaque token for :meth:`commit_frontier`.

        The capture MUST happen here, not at commit: the driver overlaps
        the commit with the next chunk, whose appends land between begin
        and commit — offsets read at commit time would let the frontier
        cover ticks the flushed snapshot never saw."""
        self.fence()
        if self.cfg.barrier:
            f_tick, f_offs = int(tick), self._offsets()
        else:
            f_tick = max(self.frontier.tick, int(tick) - self.slack)
            cands = [offs for t, offs in self._tick_offsets.items()
                     if t >= f_tick]
            f_offs = [min(c[i] for c in cands) if cands
                      else self.wals[i].offset
                      for i in range(len(self.wals))]
        self._tick_offsets = {t: o for t, o in self._tick_offsets.items()
                              if t >= f_tick}
        return (f_tick, f_offs)

    def commit_frontier(self, token, meta: Optional[dict] = None, *,
                        save: bool = True):
        """Phase two: drain the flusher (re-raises on store failure),
        then persist the frontier captured by :meth:`begin_frontier`.
        Blocking — the driver calls this after dispatching the next
        chunk so the drain overlaps device compute.  ``meta`` is an
        opaque driver cursor stored alongside (None keeps the previous
        one).  A multi-rank engine passes every shard's offsets (its
        ranks' tokens gathered) and ``save`` on one rank only."""
        f_tick, f_offs = token
        self.flusher.drain()
        self.frontier = FlushFrontier(
            tick=f_tick,
            wal_offset=f_offs[0] if self.n_shards is None else list(f_offs),
            meta=meta if meta is not None else self.frontier.meta)
        if save:
            self.frontier.save(self.cfg.frontier_path())
        if self.cfg.truncate_wal:
            for w, off in zip(self.wals, f_offs[self.first:]):
                w.truncate_before(off)

    def record_frontier(self, tick: int, meta: Optional[dict] = None):
        """Synchronous frontier advance: fence + capture + drain + save
        in one call (checkpoint/drain/recovery paths; the pipelined hot
        loop uses begin/commit directly).  With the barrier the pipeline
        is empty, so the frontier is exactly ``tick``; without it the
        frontier is backdated by ``replay_slack`` ticks."""
        self.commit_frontier(self.begin_frontier(tick), meta=meta)

    def frontier_offsets(self) -> List[int]:
        off = self.frontier.wal_offset
        return list(off) if isinstance(off, (list, tuple)) else [off]

    def resize(self, n_shards: int, *, first: int = 0,
               n_local: Optional[int] = None,
               offsets: Optional[Callable[[], List[int]]] = None,
               save: bool = True):
        """Live elasticity (DESIGN.md sections 12/14): match the
        per-shard WAL set to the new physical shard count and re-record
        the frontier with the adjusted offset list.  Called at a scale
        boundary right after a flush barrier, so every shard's frontier
        offset is current: growth takes the new WALs' ends (their
        empty heads); a compaction shrink drops the offsets of the
        dropped slots — sound only behind the barrier, which
        guarantees those files hold no records past the frontier
        (replay re-routes every event by key, so WAL-slot identity
        never matters).  Deactivated-but-not-compacted shards keep
        their WAL — it simply receives nothing until the slot
        rejoins.

        One rank of a multi-rank engine holds shards ``first .. first +
        n_local - 1`` (by default all ``n_shards``): it reopens those
        WALs, ``offsets`` gives every shard's current end (gathered from
        the ranks; by default this object's own), and only the rank
        with ``save`` writes the frontier file."""
        if self.n_shards is None:
            raise ValueError("resize() is for per-shard durability")
        self.fence()   # the writer must not touch WALs we close/open
        old = self.frontier_offsets()
        for w in self.wals:
            w.close()
        self.first = first
        self.n_shards = n_shards if n_local is None else n_local
        self.wals = [WriteAheadLog(self.cfg.wal_path(first + s),
                                   sync=self.cfg.sync_wal)
                     for s in range(self.n_shards)]
        cur = (offsets or self._offsets)()
        self.frontier = FlushFrontier(
            tick=self.frontier.tick,
            wal_offset=old[:n_shards] + cur[len(old):n_shards],
            meta=self.frontier.meta)
        if save:
            self.frontier.save(self.cfg.frontier_path())

    def close(self):
        try:
            self._wq.join()
            self._wq.put(None)
            self._wthread.join(timeout=5)
        finally:
            try:
                self.flusher.close()
            finally:
                for w in self.wals:
                    w.close()


def merge_replay_ticks(wals: List[WriteAheadLog], offsets: List[int]):
    """Merge per-shard WAL suffixes into a sorted per-tick stream:
    yields ``(tick, {shard: {stream: EventBatch}})``."""
    by_tick: Dict[int, Dict[int, dict]] = {}
    for s, (w, off) in enumerate(zip(wals, offsets)):
        for t, src in w.replay(from_offset=off):
            by_tick.setdefault(int(t), {})[s] = src
    for t in sorted(by_tick):
        yield t, by_tick[t]


def stage_sources(sources):
    """Host copies of one tick's source batches, for the writer thread:
    on a CUDA device a non-blocking copy into pinned memory issued on the
    current stream (the one that runs the ticks, so the copy reads each
    batch before any later tick could write it) and the event recorded
    after it; on the CPU a clone and no event.  Returns (staged, event)."""
    on_card = False

    def copy(t):
        nonlocal on_card
        if not t.is_cuda:
            return t.clone()
        on_card = True
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    staged = {s: tree_map(copy, b) for s, b in sources.items()}
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record()
    return staged, event
