"""Single-shard MapUpdate engine (port of ``repro.core.engine``).

Execution model (DESIGN.md section 2): every tick each operator dequeues
up to ``batch_size`` events, applies its vectorized function, and
emitted events are enqueued at their subscribers for the next tick.
End-to-end latency = graph depth x tick latency, as in Muppet's
pipeline; there is no master on the data path.

Two dispatch granularities:
  - ``step``: one tick per host call;
  - ``run_chunk``: T ticks over pre-staged (stacked) sources.  The JAX
    package rolls them into one ``lax.scan``; here the chunk is a Python
    loop over ticks that never reads the device from the host inside a
    tick (no ``.item()``, no ``bool(tensor)``, no mask indexing), so the
    whole chunk is enqueued ahead of the card and the host syncs once
    per chunk, in ``run``.  It is the same code as ``step``, so a chunk
    is bitwise equal to T ``step`` calls.

State is a dict of tensors and dataclasses of tensors.  Ticks update
queue buffers and slate tables in place, where the JAX engine donates
the state: as there, pass a state to ``step`` / ``run_chunk`` / ``run``
and use the one they return.

With ``EngineConfig.telemetry`` set, each updater's dequeued batch also
folds its keys into a count-min sketch and its events' ages into a
per-arc latency histogram (``kernels/countmin``, ``kernels/histogram``),
state the tick writes and never reads; ``run`` reads both at window
boundaries into a ``TelemetryReport`` without a host sync inside a tick.
``StateHandle`` serves slates, ``/status`` and ``/metrics`` over HTTP.

With ``EngineConfig.durability`` set (``core/durability.py``), ``run``
appends every tick's sources to a write-ahead log before the chunk that
consumes them, flushes the dirty slates to a replicated KV store at
flush boundaries and records the flush frontier once they are durable;
``recover`` rebuilds the state after a crash from the store and the log
suffix (DESIGN.md section 10).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device, torch_dtype
from repro_torch.core import apply as apply_mod
from repro_torch.core import queues as q_mod
from repro_torch.core.durability import DurabilityConfig, EngineDurability
from repro_torch.core.event import EventBatch, concat, tree_map
from repro_torch.core.operators import (AssociativeUpdater, Mapper,
                                        SequentialUpdater, Updater)
from repro_torch.core.queues import OverflowPolicy
from repro_torch.core.workflow import Workflow
from repro_torch.kernels.slate_lookup import ops as lk_ops
from repro_torch.slates import flush as flush_mod
from repro_torch.slates import table as tbl
from repro_torch.telemetry import latency as lat_mod
from repro_torch.telemetry import sketch as sk_mod
from repro_torch.telemetry.metrics import MetricsRegistry, TelemetryConfig
from repro_torch.telemetry.trace import Tracer, null_span


@dataclass
class EngineConfig:
    batch_size: int = 256
    queue_capacity: int = 1024
    overflow: Dict[str, OverflowPolicy] = field(default_factory=dict)
    overflow_stream: Dict[str, str] = field(default_factory=dict)
    default_policy: OverflowPolicy = OverflowPolicy.DROP
    # fused slate-update backend for sum_mergeable / monoid updaters:
    # "auto" (the CUDA kernel on a CUDA device, the plain packed-table
    # version on the CPU), "cuda", "jnp", "ref", or "off" (always the
    # generic path).  See core/apply.apply_associative.
    fused: str = "auto"
    # key plane width, end-to-end: "int32" (default) or "int64"
    key_dtype: str = "int32"
    # ticks per chunk in run(); 1 = per-tick host sync
    chunk_size: int = 8
    # durable runtime (WAL + slate flush + crash recovery, DESIGN.md 10);
    # None = fast but amnesiac
    durability: Optional[DurabilityConfig] = None
    # device-side telemetry (DESIGN.md 13, 18): a count-min key-heat
    # sketch and per-arc latency histograms updated inside the tick + a
    # windowed metrics registry read at window boundaries.  None = no
    # telemetry state, no readings.
    telemetry: Optional[TelemetryConfig] = None

    def policy_for(self, op_name: str) -> OverflowPolicy:
        return self.overflow.get(op_name, self.default_policy)


def stack_sources(per_tick: Sequence[Dict[str, EventBatch]]
                  ) -> Dict[str, EventBatch]:
    """Stack T per-tick source dicts into one dict of EventBatches with a
    leading tick axis [T, B, ...] — the pre-staged input of
    ``run_chunk``.  Missing streams are padded with all-invalid batches
    and smaller batches are padded to the chunk's max capacity."""
    if not per_tick:
        raise ValueError("need at least one tick of sources")
    caps: Dict[str, int] = {}
    templates: Dict[str, EventBatch] = {}
    for d in per_tick:
        for s, b in d.items():
            if s not in caps or b.capacity > caps[s]:
                caps[s], templates[s] = b.capacity, b

    def get(d, s):
        if s in d:
            return d[s].pad_to(caps[s])
        tmpl = templates[s]
        return tmpl.mask(torch.zeros_like(tmpl.valid))

    return {s: tree_map(lambda *xs: torch.stack(xs),
                        *[get(d, s) for d in per_tick])
            for s in templates}


def _limit_ingest(batch: EventBatch, ingest) -> EventBatch:
    """Keep only the first ``ingest`` valid events (device-side source
    throttling inside a chunk)."""
    rank = torch.cumsum(batch.valid.to(torch.int32), 0) - 1
    return batch.mask(rank < ingest)


def resolve_key_dtype(name) -> torch.dtype:
    """Validate an ``EngineConfig.key_dtype``: int32 or int64.  (The JAX
    package also demands ``jax_enable_x64`` for int64; torch never
    demotes int64.)"""
    dt = torch_dtype(name)
    if dt not in (torch.int32, torch.int64):
        raise ValueError(f"key_dtype must be int32 or int64, got {name!r}")
    return dt


# the served reads a drain runs, by their code in the packed requests
READ_KINDS = ("slate", "slates", "status", "metrics")


def pack_requests(reqs, updaters: Sequence[str]) -> np.ndarray:
    """``[(kind, updater, keys), ...]`` as one int64 vector: for each
    request its kind's index in ``READ_KINDS``, its updater's index in
    ``updaters`` (-1 for none), its key count, then its keys."""
    out: List[int] = []
    for kind, updater, keys in reqs:
        keys = [int(k) for k in keys]
        out += [READ_KINDS.index(kind),
                -1 if updater is None else updaters.index(updater),
                len(keys), *keys]
    return np.asarray(out, dtype=np.int64)


def unpack_requests(words, updaters: Sequence[str]):
    """The inverse of :func:`pack_requests`."""
    words = np.asarray(words, dtype=np.int64)
    reqs, i = [], 0
    while i < len(words):
        kind, u, n = (int(x) for x in words[i:i + 3])
        reqs.append((READ_KINDS[kind], None if u < 0 else updaters[u],
                     [int(k) for k in words[i + 3:i + 3 + n]]))
        i += 3 + n
    return reqs


@dataclass
class _Request:
    kind: str
    updater: Optional[str]
    keys: List[int]
    future: Future


class StateHandle:
    """Live view of ``(engine, state)`` for concurrent readers.

    ``Engine.run(..., handle=h)`` republishes ``h.state`` after every
    chunk, so a reader thread (the HTTP slate server of :meth:`serve`)
    sees live slates without the caller threading state through it.
    Reads hold the engine's ``read_lock``, which ``run`` holds while a
    chunk updates the state in place.

    On an engine with a process group (``engine.group``, a world of one
    included) a read is a collective every rank must enter in the same
    order, so the server's threads never read: each HTTP request goes on
    the handle's read queue and waits for an answer.  Every rank calls
    :meth:`serve`, then :meth:`drain` at the same points, where ``run``
    republishes the state (after each chunk and each reconfigure), and
    at :meth:`close`: rank 0 broadcasts its queued requests, every rank
    runs their reads in that order, and rank 0 answers them, each with
    the source tick it was read at.  A handle that serves nothing never
    drains, so an unserved run makes no collective of its own.  Keys
    outside the engine's key type are refused before they are queued
    (HTTP 400).  The handle's own ``read_slate`` / ``read_slates``
    / ``stats`` / ``metrics_text`` stay direct reads (collectives there,
    made by every rank)."""

    def __init__(self, engine, state=None, cache=None, *,
                 timeout: float = 30.0):
        self.engine = engine
        self.state = state
        # optional slates.replica.HotKeyCache: consulted before touching
        # device state, warmed from telemetry heavy hitters, invalidated
        # whenever the flush frontier advances (DESIGN.md section 15)
        self.cache = cache
        # the read queue (an engine with a group): a served request
        # waits ``timeout`` s for a drain before it answers 503
        self.group = getattr(engine, "group", None)
        self.timeout = timeout
        self._queue: deque = deque()
        self._queue_lock = threading.Lock()
        self._closed = False
        self._servers: list = []

    def _lock(self):
        return getattr(self.engine, "read_lock", None) or nullcontext()

    def read_slate(self, updater: str, key: int):
        # over a group this read is a collective: a hit on one rank's
        # cache would leave the others waiting in it
        c = self.cache if self.group is None else None
        if c is not None:
            hit, val = c.get(updater, key)
            if hit:
                return val
        with self._lock():
            val = self.engine.read_slate(self.state, updater, key)
        if c is not None and val is not None:
            c.put(updater, key, val)
        return val

    def read_slates(self, updater: str, keys):
        """Batched point reads; list aligned with ``keys``, ``None`` for
        missing."""
        with self._lock():
            return self.engine.read_slates(self.state, updater, keys)

    def stats(self) -> Dict[str, Any]:
        with self._lock():
            return self.engine.stats(self.state)

    # -- run-loop hooks (Engine.run calls these at chunk boundaries) --
    def on_telemetry(self, report):
        if self.cache is not None and report is not None:
            self.cache.warm([k for k, _, _ in report.heavy_hitters])

    def on_frontier_advance(self):
        """Flush frontier moved: cached rows may now disagree with the
        durable snapshot — drop them."""
        if self.cache is not None:
            self.cache.invalidate()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the engine's current counters,
        latest telemetry window and cumulative latency histograms, from
        snapshots the registry already holds plus one ``stats()`` read."""
        from repro_torch.telemetry.prom import render_prometheus
        reg = self.engine.telemetry
        return render_prometheus(
            stats=self.stats(),
            report=reg.last if reg is not None else None,
            hist=reg.hist_cum if reg is not None else None,
            n_buckets=(reg.cfg.latency_buckets
                       if reg is not None else lat_mod.N_BUCKETS))

    def serve(self, port: int = 0):
        """Start an HTTP slate server bound to this handle (127.0.0.1;
        ``port=0`` picks a free port); :meth:`close` stops it.  On an
        engine with a group every rank calls it and only rank 0 serves,
        through the read queue (each answer carries its source tick);
        the other ranks get a ``NoServer`` (``port`` None)."""
        from repro_torch.slates.http import NoServer, SlateServer
        if self.group is None:
            srv = SlateServer(read_fn=self.read_slate, stats_fn=self.stats,
                              read_many_fn=self.read_slates,
                              metrics_fn=self.metrics_text, port=port)
        elif self.engine.rank != 0:
            srv = NoServer()
        else:
            srv = SlateServer(
                read_fn=self._served_slate,
                stats_fn=lambda: self._ask("status"),
                read_many_fn=lambda u, keys: self._ask("slates", u, keys),
                metrics_fn=lambda: self._ask("metrics"), port=port,
                ticked=True)
        self._servers.append(srv)
        return srv

    # -- the read queue (an engine with a group) --
    def _updaters(self) -> List[str]:
        return [u.name for u in self.engine.wf.updaters()]

    def _served_slate(self, updater: str, key: int):
        c = self.cache
        if c is not None:
            hit, val = c.get(updater, key)
            if hit:
                return val, None
        val, tick = self._ask("slate", updater, [key])
        if c is not None and val is not None:
            c.put(updater, key, val)
        return val, tick

    def _ask(self, kind: str, updater: Optional[str] = None, keys=()):
        """Queue a read for the next drain and wait for its answer:
        ``(value, source tick)``.  A key the engine's key type cannot
        hold is refused here (HTTP 400), so no drain ever packs it."""
        from repro_torch.slates.http import BadRequest, Unavailable
        if updater is not None and updater not in self._updaters():
            raise KeyError(updater)
        keys = [int(k) for k in keys]
        half = 1 << (self.engine.key_bits - 1)
        if any(not -half <= k < half for k in keys):
            raise BadRequest(f"a key outside int{self.engine.key_bits}")
        req = _Request(kind, updater, keys, Future())
        with self._queue_lock:
            if self._closed:
                raise Unavailable("the slate handle is closed")
            self._queue.append(req)
        try:
            return req.future.result(timeout=self.timeout)
        except FutureTimeout:
            if req.future.cancel():
                raise Unavailable(f"no drain within {self.timeout} s")
            try:            # a drain took it: its answer is on the way
                return req.future.result(timeout=self.timeout)
            except FutureTimeout:
                raise Unavailable(f"the drain did not answer within "
                                  f"{self.timeout} s")

    def _read(self, kind: str, updater: Optional[str], keys):
        if kind == "slate":
            return self.read_slate(updater, keys[0])
        if kind == "slates":
            return self.read_slates(updater, keys)
        return self.stats() if kind == "status" else self.metrics_text()

    def _take(self, names: Sequence[str]):
        """Rank 0's queued requests in FIFO order and their packed
        words; a request that does not pack fails alone (HTTP 500)."""
        taken, words = [], []
        with self._queue_lock:
            while self._queue:
                req = self._queue.popleft()
                if not req.future.set_running_or_notify_cancel():
                    continue
                try:
                    words.append(pack_requests(
                        [(req.kind, req.updater, req.keys)], names))
                    taken.append(req)
                except Exception as e:
                    req.future.set_exception(e)
        return taken, np.concatenate(words or [np.zeros(0, np.int64)])

    def drain(self, tick: Optional[int] = None) -> int:
        """Answer the queued reads (collective: every rank calls it at
        the same point).  Rank 0 takes its queue in FIFO order and
        broadcasts it (the request count and word count, then, if any,
        the packed requests); every rank runs the reads in that order on
        the current state; rank 0 completes the requests with
        ``(value, tick)``, ``tick`` defaulting to the engine's source
        cursor.  Returns the number of reads; 0 at once, with no
        collective, without a group or while the handle serves nothing
        (every rank of a group calls :meth:`serve`, so all agree)."""
        if self.group is None or not self._servers:
            return 0
        from repro_torch.core.distributed import broadcast_tensor
        root = self.engine.rank == 0
        names = self._updaters()
        taken, words = self._take(names) if root else ([], None)
        try:
            dev = self.engine.device
            head = torch.tensor([len(taken), 0 if words is None else
                                 len(words)], dtype=torch.int64, device=dev)
            broadcast_tensor(head, self.group)
            n, n_words = head.tolist()
            if n == 0:
                return 0
            buf = torch.from_numpy(words).to(dev) if root else \
                torch.empty(n_words, dtype=torch.int64, device=dev)
            broadcast_tensor(buf, self.group)
            reqs = unpack_requests(buf.cpu().numpy(), names)
            if tick is None:
                tick = getattr(self.engine, "tick_cursor", None)
            answers = []
            with self._lock():
                for kind, updater, keys in reqs:
                    try:
                        answers.append((self._read(kind, updater, keys),
                                        None))
                    except Exception as e:      # answered as a 500
                        answers.append((None, e))
        except BaseException as e:
            for req in taken:
                req.future.set_exception(e)
            raise
        for req, (value, err) in zip(taken, answers):
            if err is not None:
                req.future.set_exception(err)
            else:
                req.future.set_result((value, tick))
        return n

    def close(self):
        """Stop serving: no request is queued after this; every rank
        takes one last drain (collective, on an engine with a group that
        serves), so the queued reads are answered; then the server
        stops."""
        with self._queue_lock:
            self._closed = True
        try:
            self.drain()
        finally:
            for srv in self._servers:
                srv.close()
            self._servers.clear()


class Engine:
    """Runs the tick from the host.  ``device`` defaults to ``cuda``;
    pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, workflow: Workflow, config: EngineConfig = None,
                 device=None):
        self.wf = workflow
        self.cfg = config or EngineConfig()
        self.device = resolve_device(device)
        self.key_dtype = resolve_key_dtype(self.cfg.key_dtype)
        # serializes concurrent readers against run(), which updates the
        # state in place chunk by chunk
        self.read_lock = threading.RLock()
        self.telemetry: Optional[MetricsRegistry] = None
        self.tracer: Optional[Tracer] = None
        if self.cfg.telemetry is not None:
            self.telemetry = MetricsRegistry(
                self.cfg.telemetry, batch_size=self.cfg.batch_size)
            if self.cfg.telemetry.trace:
                self.tracer = Tracer()
        self.dur: Optional[EngineDurability] = None
        if self.cfg.durability is not None:
            self.dur = EngineDurability(self.cfg.durability, workflow,
                                        self.cfg.queue_capacity,
                                        self.cfg.batch_size)

    def _span(self, name: str, **args):
        """Tracer span when tracing is on, else a free no-op."""
        return self.tracer.span(name, **args) if self.tracer \
            else null_span(**args)

    @property
    def key_bits(self) -> int:
        return self.key_dtype.itemsize * 8

    # ---- state ----
    def init_state(self) -> Dict[str, Any]:
        kd, dev = self.key_dtype, self.device
        queues = {op.name: q_mod.make_queue(self.cfg.queue_capacity,
                                            op.in_value_spec, key_dtype=kd,
                                            device=dev)
                  for op in self.wf.operators}
        tables = {up.name: tbl.make_table(up.table_capacity, up.slate_spec(),
                                          key_dtype=kd, device=dev)
                  for up in self.wf.updaters()}
        z = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        state = {
            "queues": queues,
            "tables": tables,
            "tick": z(),
            "throttle_hits": z(),
            "deferred": z(),
            "processed": {op.name: z() for op in self.wf.operators},
        }
        tc = self.cfg.telemetry
        if tc is not None:
            state["sketch"] = sk_mod.make_sketch(tc.depth, tc.width,
                                                 tc.sample, key_dtype=kd,
                                                 device=dev)
            if tc.latency_buckets > 0:
                state["lat_hist"] = lat_mod.make_hist(
                    [u.name for u in self.wf.updaters()],
                    tc.latency_buckets, device=dev)
        return state

    # ---- one tick ----
    def _tick(self, state, sources: Dict[str, EventBatch]):
        cfg, wf = self.cfg, self.wf
        queues = dict(state["queues"])
        tables = dict(state["tables"])
        processed = dict(state["processed"])
        throttle_hits = state["throttle_hits"]
        deferred_total = state["deferred"]
        tick = state["tick"]
        sketch = state.get("sketch")
        lat_hist = dict(state["lat_hist"]) if "lat_hist" in state \
            else None
        outputs: Dict[str, List[EventBatch]] = {}
        for s, b in sources.items():
            if b.device != self.device:
                raise ValueError(f"source {s!r} is on {b.device}, the "
                                 f"engine on {self.device}")

        def deliver_all(items: List[Tuple[str, EventBatch]]):
            """Route batches to subscriber queues; overflow-stream policy
            may chain (bounded — cycles are a config error)."""
            nonlocal throttle_hits
            work = deque(items)
            for _ in range(len(work) + 64):
                if not work:
                    return
                stream, batch = work.popleft()
                subs = wf.dests_of(stream)
                if not subs:
                    outputs.setdefault(stream, []).append(batch)
                    continue
                for dest in subs:
                    nq, ovf = q_mod.enqueue(queues[dest], batch)
                    pol = cfg.policy_for(dest)
                    if pol is OverflowPolicy.DROP:
                        nq = q_mod.count_drop(nq, ovf)
                    elif pol is OverflowPolicy.OVERFLOW_STREAM:
                        work.append((cfg.overflow_stream[dest], ovf))
                    elif pol is OverflowPolicy.THROTTLE:
                        throttle_hits = throttle_hits + ovf.count()
                        nq = q_mod.count_drop(nq, ovf)
                    queues[dest] = nq
            raise RuntimeError("overflow-stream routing did not converge "
                               "(cycle in overflow_stream config?)")

        # 1. deliver sources (visible to operators this tick; operator
        #    emissions become visible next tick — pipelined execution)
        deliver_all(list(sources.items()))
        emitted_now: List[Tuple[str, EventBatch]] = []

        # 2. apply operators on their queues
        for op in wf.operators:
            queues[op.name], batch = q_mod.dequeue(queues[op.name],
                                                   cfg.batch_size)
            if sketch is not None and isinstance(op, Updater):
                # key-heat telemetry on the keys each updater processes:
                # state the tick never reads (the parity contract)
                sketch = sk_mod.sketch_update(
                    sketch, batch.key, batch.valid, self.telemetry.salts,
                    impl=cfg.telemetry.impl)
            if lat_hist is not None and isinstance(op, Updater):
                # event-latency telemetry (DESIGN.md 18): each event's
                # age at dequeue, binned into this arc's histogram
                lat_hist[op.name] = lat_mod.hist_update(
                    lat_hist[op.name], tick, batch.ts, batch.valid,
                    n_buckets=cfg.telemetry.latency_buckets,
                    impl=cfg.telemetry.impl)
            if isinstance(op, Mapper):
                outs = op.map_batch(batch)
                for s, b in outs.items():
                    emitted_now.append((s, b.mask(batch.valid & b.valid)))
                processed[op.name] = processed[op.name] + batch.count()
            elif isinstance(op, AssociativeUpdater):
                tables[op.name], ems, n = apply_mod.apply_associative(
                    op, tables[op.name], batch, tick, impl=cfg.fused)
                emitted_now.extend(ems.items())
                processed[op.name] = processed[op.name] + n
            elif isinstance(op, SequentialUpdater):
                tables[op.name], ems, deferred, n = \
                    apply_mod.apply_sequential(op, tables[op.name], batch,
                                               tick)
                emitted_now.extend(ems.items())
                # hotspot backpressure: re-queue over-budget run tails
                deferred_total = deferred_total + deferred.count()
                nq, ovf = q_mod.enqueue(queues[op.name], deferred)
                queues[op.name] = q_mod.count_drop(nq, ovf)
                processed[op.name] = processed[op.name] + n
            else:
                raise TypeError(f"unknown operator type {type(op)}")

        # 3. TTL sweeps
        for up in wf.updaters():
            if up.ttl:
                tables[up.name] = tbl.expire_ttl(tables[up.name], tick,
                                                 up.ttl)

        # 4. route this tick's emissions (visible next tick)
        deliver_all(emitted_now)

        out_batches = {s: concat(bs) if len(bs) > 1 else bs[0]
                       for s, bs in outputs.items()}
        new_state = {
            "queues": queues,
            "tables": tables,
            "tick": tick + 1,
            "throttle_hits": throttle_hits,
            "deferred": deferred_total,
            "processed": processed,
        }
        if sketch is not None:
            new_state["sketch"] = sketch
        if lat_hist is not None:
            new_state["lat_hist"] = lat_hist
        return new_state, out_batches

    # ---- host API ----
    def step(self, state, sources: Dict[str, EventBatch]):
        """One tick.  Updates ``state`` in place and returns
        ``(state, outputs)``."""
        return self._tick(state, sources)

    def run_chunk(self, state, stacked_sources: Dict[str, EventBatch],
                  n_ticks: Optional[int] = None, *,
                  ingest: Optional[int] = None, throttle_floor: int = 8):
        """Run T ticks with no host sync between them.

        ``stacked_sources``: dict of EventBatches with a leading tick
        axis [T, B, ...] (see ``stack_sources``).  Returns
        ``(state, stacked_outputs, info)`` where ``stacked_outputs``
        leaves have leading dim T and ``info`` holds the on-device
        per-tick ``throttle_hits`` trace [T] plus the final ``ingest``.

        With ``ingest=None`` the chunk is bitwise equal to T ``step``
        calls; an int enables on-device source throttling: each tick's
        sources are masked to the first ``ingest`` valid events, and the
        limit halves (not below ``throttle_floor``) after a tick with new
        throttle hits and doubles back toward ``max(ingest, batch_size)``
        otherwise.  An empty ``stacked_sources`` runs ``n_ticks``
        source-less ticks."""
        lead = {s: b.key.shape[0] for s, b in stacked_sources.items()}
        t_dim = next(iter(lead.values())) if lead else n_ticks
        if t_dim is None:
            raise ValueError("empty stacked_sources needs an explicit "
                             "n_ticks")
        if n_ticks is not None and lead and t_dim != n_ticks:
            raise ValueError(f"stacked sources have {t_dim} ticks, "
                             f"caller asked for {n_ticks}")
        adapt = ingest is not None
        dev = self.device
        ing = torch.full((), ingest if adapt else self.cfg.batch_size,
                         dtype=torch.int32, device=dev)
        ing_max = torch.clamp(ing, min=self.cfg.batch_size)
        outs_per_tick, hits = [], []
        for t in range(t_dim):
            src = {s: tree_map(lambda a, t=t: a[t], b)
                   for s, b in stacked_sources.items()}
            hits0 = state["throttle_hits"]
            if adapt:
                src = {s: _limit_ingest(b, ing) for s, b in src.items()}
            state, outs = self._tick(state, src)
            if adapt:
                delta = state["throttle_hits"] - hits0
                # halve under pressure; double back toward the ceiling
                ing = torch.where(delta > 0,
                                  torch.clamp(ing // 2, min=throttle_floor),
                                  torch.minimum(ing_max, ing * 2))
            outs_per_tick.append(outs)
            hits.append(state["throttle_hits"])
        stacked_outs = {s: tree_map(lambda *xs: torch.stack(xs),
                                    *[o[s] for o in outs_per_tick])
                        for s in (outs_per_tick[0] if outs_per_tick else {})}
        return state, stacked_outs, {"throttle_hits": torch.stack(hits),
                                     "ingest": ing}

    def run(self, state, source_fn, n_ticks: int, *,
            throttle_floor: int = 8, chunk_size: Optional[int] = None,
            source_offset: int = 0,
            handle: Optional[StateHandle] = None):
        """Drive the engine with *source throttling* (paper section 5):
        while throttle hits grow, halve the ingest batch until queues
        drain.  ``source_fn(tick, max_events) -> dict[stream,
        EventBatch]``.

        Ticks run in chunks of ``chunk_size`` (default
        ``cfg.chunk_size``); the host reads the throttle trace once per
        chunk — one sync per chunk — and replays the per-tick
        halve/double rule over it, so the ingest limit handed to
        ``source_fn`` reacts at chunk boundaries.  ``chunk_size=1``
        recovers exact per-tick backpressure.  ``handle`` is republished
        with the current state after every chunk.

        With ``cfg.durability`` set, every per-tick source dict is
        appended to the WAL *before* the chunk that consumes it, and at
        chunk boundaries the flush policy may start a durable slate
        flush; its frontier commits after the next chunk is dispatched,
        so the store writes overlap device work (DESIGN.md sections 10,
        17).  Drain ticks of the flush barrier advance the engine tick
        counter, so ``source_fn``'s tick argument (the source index) and
        ``stats()['tick']`` diverge by the number of drain ticks.

        ``source_offset`` resumes an interrupted source stream:
        ``source_fn`` is called with absolute indices ``offset ..
        offset+n_ticks`` and chunk grouping stays aligned to the absolute
        index, so a recovered run flushes (and drains) at the same
        boundaries as the uninterrupted run — the bitwise-parity
        contract of ``recover()``.

        With ``cfg.telemetry`` set, every ``window`` source ticks the
        boundary starts a copy of the counters, sketch and histograms to
        the host and decays the sketch; the report resolves after the
        next chunk is dispatched (one-chunk lag, so the copy overlaps
        device work) and goes to ``handle.on_telemetry``.  The run does
        not return with a report or a frontier unresolved."""
        chunk = chunk_size or self.cfg.chunk_size
        outputs = []
        ingest = None
        obs_mark = source_offset    # telemetry window cursor
        pending_flush = None        # flush begun, frontier not committed
        pending_obs = None          # in-flight telemetry transfer
        # throttle_hits is cumulative: resuming from prior state must not
        # read old hits as a fresh backpressure signal
        last_hits = int(state["throttle_hits"].item())
        t = source_offset
        end = source_offset + n_ticks
        eng_tick = int(state["tick"].item()) if self.dur else 0
        while t < end:
            n = min(chunk - t % chunk, end - t)
            per_tick = [source_fn(t + i, ingest) for i in range(n)]
            if self.dur:
                for i, srcs in enumerate(per_tick):
                    self.dur.append(eng_tick + i, srcs)   # async writer
            # the chunk updates the state in place: hold the read lock
            # until the new state is republished
            with self.read_lock:
                with self._span("chunk_dispatch", tick=t, n_ticks=n):
                    state, outs, info = self.run_chunk(
                        state, stack_sources(per_tick), n)
                # the chunk is in flight: resolve the previous boundary's
                # deferred work while the device computes
                if pending_flush is not None:
                    self._commit_span(pending_flush, handle)
                    pending_flush = None
                if pending_obs is not None:
                    self._finish_observe(pending_obs, handle)
                    pending_obs = None
                for i in range(n):
                    outputs.append(tree_map(lambda x, i=i: x[i], outs))
                hits_trace = info["throttle_hits"].tolist()  # 1 sync
                for hits in hits_trace:
                    if hits > last_hits:     # backpressure signal
                        cur = (ingest if ingest is not None
                               else self.cfg.batch_size)
                        ingest = max(throttle_floor, cur // 2)
                    elif ingest is not None:
                        ingest = min(self.cfg.batch_size, ingest * 2)
                        if ingest == self.cfg.batch_size:
                            ingest = None
                    last_hits = hits
                t += n
                eng_tick += n
                if self.dur and self.dur.due(eng_tick, state["tables"]):
                    with self._span("flush_begin", tick=t):
                        state, eng_tick, pending_flush = self._flush_begin(
                            state, eng_tick, meta={"source_tick": t})
                if (self.telemetry is not None
                        and t - obs_mark >= self.cfg.telemetry.window):
                    with self._span("observe_begin", tick=t):
                        pending_obs = self.telemetry.begin_observe(
                            self, state)
                    state = dict(state)
                    state["sketch"] = sk_mod.decay(
                        state["sketch"], self.cfg.telemetry.decay)
                    obs_mark = t
                if handle is not None:
                    handle.state = state
        if pending_flush is not None:
            self._commit_span(pending_flush, handle)
        if pending_obs is not None:
            self._finish_observe(pending_obs, handle)
        if self.dur:
            # run() is a durable unit: every source batch it consumed is
            # on disk (and append errors surface) before control returns
            with self._span("wal_fence"):
                self.dur.fence()
        return state, outputs

    def _finish_observe(self, pending, handle):
        with self._span("observe_finish"):
            report = self.telemetry.finish_observe(pending)
        if handle is not None:
            handle.on_telemetry(report)

    def _commit_span(self, pending, handle):
        with self._span("flush_commit") as sp:
            self._flush_commit(pending, sp)
        if handle is not None:
            handle.on_frontier_advance()

    def drain(self, state, max_ticks: int = 64):
        """Run source-less ticks until every queue is empty (or
        ``max_ticks``) — flushes in-flight events through the remaining
        pipeline hops.  Returns ``(state, ticks_run)``."""
        return self._drain_queues(state, max_ticks)

    # ---- durability (DESIGN.md section 10) ----
    def _drain_queues(self, state, max_ticks: int):
        """Run source-less ticks until every queue is empty — the flush
        barrier.  Each probe costs one host sync; barriers are rare
        (flush boundaries only).  Returns (state, ticks_run)."""
        d = 0
        while d < max_ticks:
            sizes = torch.stack([q.size for q in state["queues"].values()])
            if int(sizes.max().item()) == 0:
                break
            state, _ = self._tick(state, {})
            d += 1
        return state, d

    def _flush_begin(self, state, eng_tick: int, meta=None):
        """First half of a flush boundary: drain (per config), start the
        snapshot of every table (device clones; the tables' dirty bits
        are cleared in place at once), and fence the WAL writer to pin
        the frontier's replay point *before* any later tick appends.
        The blocking store-side work lives in :meth:`_flush_commit`,
        which the driver calls after the next chunk's dispatch so it
        overlaps device compute.  Returns ``(state, eng_tick,
        pending)``."""
        dur = self.dur
        if dur.cfg.barrier:
            state, d = self._drain_queues(state, dur.cfg.drain_ticks_max)
            eng_tick += d
        snaps = [(up.name, up.ttl,
                  flush_mod.begin_dirty_snapshot(state["tables"][up.name]))
                 for up in self.wf.updaters()]
        f_token = dur.begin_frontier(eng_tick)
        return state, eng_tick, (snaps, f_token, meta)

    def _flush_commit(self, pending, span=None):
        """Second half: resolve the snapshots to host rows, hand them to
        the flusher, and commit the frontier once the store writes are
        durable (raises :class:`FlushError` without saving otherwise).
        ``meta`` is the driver cursor stored with the frontier (run()
        records the source index so a recovering driver can resume its
        stream even after full WAL truncation).  ``span``, a dict, gets
        the rows flushed and the store bytes written."""
        snaps, f_token, meta = pending
        dur = self.dur
        rows = 0
        written = dur.store.bytes_written
        for name, ttl, token in snaps:
            keys, ts, vals = flush_mod.finish_dirty_snapshot(token)
            dur.flusher.flush_rows(name, keys, ts, vals, ttl=ttl)
            rows += len(keys)
        dur.commit_frontier(f_token, meta=meta)
        if span is not None:
            span["rows"] = rows
            span["store_bytes"] = dur.store.bytes_written - written

    def _flush_boundary(self, state, eng_tick: int, meta=None):
        """Synchronous flush boundary (checkpoint / shutdown / tests):
        begin + commit back to back — no overlap, identical durability
        semantics."""
        state, eng_tick, pending = self._flush_begin(state, eng_tick,
                                                     meta=meta)
        self._flush_commit(pending)
        return state, eng_tick

    def checkpoint(self, state):
        """Force a flush boundary now (shutdown / test hook); returns the
        state (flushed tables are marked clean)."""
        if self.dur is None:
            raise ValueError("engine has no durability config")
        state, _ = self._flush_boundary(state, int(state["tick"].item()))
        return state

    def recover(self, store=None, wal=None, *, frontier=None):
        """Rebuild engine state after a crash: restore flushed slates
        from the KV store, then replay the WAL suffix from the flush
        frontier through the chunk path (DESIGN.md section 10).

        ``store`` / ``wal`` / ``frontier`` default to the engine's own
        durability runtime (``cfg.durability.dir``).  Returns the
        recovered state, positioned at the last WAL tick; resume with
        ``run()``/``step()`` as usual.  Stats counters (processed,
        drops) restart at the frontier — only slates and the tick
        counter are recovered state.  The log's batches come back on the
        CPU and are moved to the engine's device.
        """
        dur = self.dur
        store = store if store is not None else (dur and dur.store)
        wal = wal if wal is not None else (dur and dur.wal)
        if frontier is None:
            frontier = dur.frontier if dur else flush_mod.FlushFrontier()
        if not store or not wal:
            raise ValueError("recover() needs a store and a wal (or "
                             "cfg.durability)")
        f_tick = int(frontier.tick)
        f_off = frontier.wal_offset
        f_off = f_off[0] if isinstance(f_off, (list, tuple)) else f_off

        t_recover = time.perf_counter()
        state = self.init_state()
        state["tick"].fill_(f_tick)
        with self._span("recover_restore", frontier=f_tick) as sp:
            sp["rows"] = 0
            for up in self.wf.updaters():
                rows = store.scan_rows(up.name,
                                       now=f_tick if up.ttl else None)
                if rows is None:
                    continue
                ks, ts, slates = rows
                flush_mod.restore_into(state["tables"][up.name], ks,
                                       slates, ts)
                sp["rows"] += len(ks)

        # replay, preserving the per-tick batch structure (gaps in the
        # log — drain ticks, empty-source ticks — replay as empty ticks)
        chunk = self.cfg.chunk_size
        pending: List[Dict[str, EventBatch]] = []
        replayed = 0

        def flush_pending():
            nonlocal state, pending, replayed
            while pending:
                group, pending = pending[:chunk], pending[chunk:]
                state, _, _ = self.run_chunk(
                    state, stack_sources(group), len(group))
                replayed += len(group)

        to_dev = lambda t: t.to(self.device)
        with self._span("recover_replay", frontier=f_tick) as sp:
            cur = f_tick
            for tk, srcs in wal.replay(from_offset=f_off):
                if tk < f_tick:
                    continue
                while cur < tk:
                    pending.append({})
                    cur += 1
                pending.append({s: tree_map(to_dev, b)
                                for s, b in srcs.items()})
                cur += 1
                if len(pending) >= 4 * chunk:
                    flush_pending()
            flush_pending()
            sp["replayed_ticks"] = replayed
        # the crash path surfaces its restore+replay wall time
        if self.telemetry is not None:
            self.telemetry.note_recovery(time.perf_counter() - t_recover)
        return state

    def close(self):
        if self.dur is not None:
            self.dur.close()

    # ---- introspection (paper section 4.4: reading slates live) ----
    def _query(self, keys) -> torch.Tensor:
        arr = np.asarray(keys, dtype=np.int64 if self.key_bits == 64
                         else np.int32).reshape(-1)
        return torch.from_numpy(arr).to(self.device)

    def read_slate(self, state, updater: str, key: int):
        """Fetch one slate (dict of host tensors, copies — never views of
        the live table, which later ticks update in place), or ``None``.
        The probe walk is ``read_slates``' (on the card the lookup
        kernel's ``keys`` route)."""
        table = state["tables"][updater]
        slot, found = lk_ops.lookup_slots(table.keys, self._query([key]),
                                          table.capacity)
        if not bool(found[0].item()):
            return None
        s = int(slot[0].item())
        return tree_map(lambda v: v[s].to("cpu", copy=True), table.vals)

    def read_slates(self, state, updater: str, keys, *,
                    impl: str = "auto"):
        """Batched point reads: one lookup launch and one host copy for a
        whole [Q] key vector, equal to Q ``read_slate`` calls.  Returns a
        list aligned with ``keys`` of per-key slate dicts (``None`` for
        missing keys).  ``impl`` picks the lookup backend
        (kernels/slate_lookup: "auto"/"cuda"/"ref"/"jnp")."""
        query = self._query(keys)
        if query.numel() == 0:
            return []
        table = state["tables"][updater]
        found, rows = lk_ops.lookup_tree(table.keys, table.vals, query,
                                         impl=impl, capacity=table.capacity)
        found = found.cpu().numpy()
        rows = tree_map(lambda r: r.cpu(), rows)
        return [tree_map(lambda v, i=i: v[i], rows) if found[i] else None
                for i in range(query.numel())]

    def stats(self, state) -> Dict[str, Any]:
        g = lambda t: int(t.item())
        return {
            "tick": g(state["tick"]),
            "throttle_hits": g(state["throttle_hits"]),
            "deferred": g(state["deferred"]),
            "processed": {k: g(v) for k, v in state["processed"].items()},
            "queue_dropped": {k: g(q.dropped)
                              for k, q in state["queues"].items()},
            "queue_peak": {k: g(q.peak) for k, q in state["queues"].items()},
            "queue_size": {k: g(q.size) for k, q in state["queues"].items()},
            "table_occupancy": {k: g(t.occupancy())
                                for k, t in state["tables"].items()},
            "table_dropped": {k: g(t.dropped)
                              for k, t in state["tables"].items()},
        }
