"""Multi-shard MapUpdate engine with every shard on one card (port of
``repro.core.distributed``, its fixed-membership half).

Muppet's data path — workers hash events to peers and write directly into
their queues — is one *exchange* per workflow hop: events are routed by
key through the hash ring (``core/hashing.py``) to the shard that owns
the key's slate, bucketed by destination, and delivered.  The JAX
package runs the tick under ``shard_map``, one device a shard, with an
``all_to_all`` in the middle of it.  Here every shard lives on one
device and the tick runs stage by stage over all of them:

- **State layout** is the JAX package's: every per-shard leaf has a
  leading ``n_shards`` dimension (queue buffers ``[S, Q+1]``, tables
  ``[S, C+1]``, counters ``[S]``).  Each stage's per-shard work is one
  loop over shards that calls the single-shard functions
  (``core/apply.py``, ``core/queues.py``, ``slates/table.py``,
  ``telemetry/{sketch,latency}.py``) on views ``x[s]`` of the stacked
  state, so the in-place slate writes land in the stacked tables; the
  small leaves a stage replaces are stacked back once per tick.
- **The exchange** works on the stacked ``[S, B]`` batches of all
  shards at once (:func:`exchange`): route, rank each event among its
  row's events for the same destination, scatter into the received
  ``[S_dst, S_src * cap]`` layout.  That scatter is the local
  permutation that stands in for ``all_to_all``: shard d receives
  source shard major, then bucket position, as the collective delivers
  it, and ``exchange_dropped`` counts the same overflow.
- **The mesh** has no devices: :func:`make_mesh` gives the axis sizes,
  all the engine reads of one (the shard count and the linear shard
  index, trailing axis fastest).  ``read_slates`` stacks the per-shard
  partials where the JAX package ``all_gather``\\ s them.

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

Live elasticity — ``scale``, ``add_shards``, ``remove_shards``,
``rebalance``, ``clear_split``, ``compact``, the migrations, the
``exchange_rows`` / ``exchange_queue`` collectives and ``run`` with
``autoscale`` set — is ROADMAP queue 1 item 15b; each raises
``NotImplementedError`` naming it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch._device import resolve_device
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
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.trace import Tracer, null_span

ELASTICITY_TODO = ("live elasticity (scale, rebalance, migrations, "
                   "autoscaling) is ported by ROADMAP queue 1 item 15b")


class NotPortedError(NotImplementedError, AttributeError):
    """A name or method of the JAX package that the port does not carry
    yet.  Also an ``AttributeError``, so ``hasattr`` and ``getattr``
    with a default treat the missing name as absent."""


# ---- the mesh ----------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """The part of a device mesh the engine reads: ordered axis names
    and their sizes.  Every shard lives on the engine's one device."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """``make_mesh((8,), ("data",))``, ``make_mesh((2, 4), ("pod",
    "data"))``: the shard grid, with no devices behind it."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "must pair up one to one")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh axes need at least one shard: {shape}")
    return Mesh(axis_names, shape)


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


# ---- the exchange ------------------------------------------------------

def exchange(batch: EventBatch, dest: torch.Tensor, n_shards: int,
             cap_per_dest: int) -> Tuple[EventBatch, torch.Tensor]:
    """Route events to their destination shards.

    ``batch`` holds the ``[S, B]`` batches of the S source shards and
    ``dest`` ``[S, B]`` their destinations.  Per (source, destination)
    bucket at most ``cap_per_dest`` events pass, in their batch order;
    the rest are dropped and counted (bounded queues, paper section
    4.3).  Returns the received batches ``[S, S * cap_per_dest]`` — row
    d holds source 0's bucket for d, then source 1's, ..., the order
    ``all_to_all`` delivers — and the drops per source shard ``[S]``.
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
    sink = n * S * cap
    flat = torch.where(ok, (d * S + src) * cap + pos, sink).reshape(-1)

    def put(a, src_vals=None):
        v = a if src_vals is None else src_vals
        out = torch.zeros((sink + 1,) + tuple(a.shape[2:]), dtype=a.dtype,
                          device=dev)
        out.index_put_((flat,), v.reshape((S * B,) + tuple(a.shape[2:])))
        return out[:sink].view((n, S * cap) + tuple(a.shape[2:]))

    received = EventBatch(
        sid=put(batch.sid), ts=put(batch.ts), key=put(batch.key),
        value=tree_map(put, batch.value), valid=put(batch.valid, ok))
    return received, dropped


def exchange_rows(*args, **kwargs):
    """Slate-row migration as one exchange: live elasticity."""
    raise NotImplementedError(ELASTICITY_TODO)


def exchange_queue(*args, **kwargs):
    """Queued-event re-homing as one exchange: live elasticity."""
    raise NotImplementedError(ELASTICITY_TODO)


# ---- stacked-state helpers ---------------------------------------------

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
    rebalance the weighted ring every k source ticks.  Carried as data
    (``RuntimeConfig(autoscale=...)`` constructs); ``run`` with a policy
    set raises until item 15b."""

    scale_at: Dict[int, int] = field(default_factory=dict)
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
    autoscale: Optional[Any] = None   # item 15b: run() raises when set
    # hot-key split set capacity (fixed shape).  0 = no split routing in
    # the tick; > 0 opts in.  Needs cfg.telemetry and no durability.
    hot_key_capacity: int = 0
    # migration tiering and compaction (item 15b), kept so configs
    # written for the JAX package construct unchanged
    device_migration: str = "auto"
    compact_threshold: float = 0.75


# ---- the engine --------------------------------------------------------

class DistributedEngine:
    """Global state lives stacked on dim 0 (the shard axis) of every
    leaf, all on ``device`` (default ``cuda``; ``device="cpu"`` runs on
    the CPU)."""

    def __init__(self, workflow: Workflow, mesh: Mesh,
                 config: Optional[DistConfig] = None, device=None):
        self.wf = workflow
        self.mesh = mesh
        self.cfg = config or DistConfig()
        self.device = resolve_device(device)
        self.key_dtype = resolve_key_dtype(self.cfg.key_dtype)
        self.axes = tuple(self.cfg.axis_names)
        self.n_shards = int(np.prod([mesh.shape[a] for a in self.axes]))
        self.ring = HashRing(self.n_shards)
        self._upload_ring()
        cap = int(self.cfg.batch_size * self.cfg.exchange_slack
                  / self.n_shards)
        self.cap_per_dest = max(8, cap)
        # serializes slate readers against run(), which updates the
        # state in place chunk by chunk
        self.read_lock = threading.RLock()
        self.tick_cursor = 0      # post-run() *source* cursor
        self.dur: Optional[EngineDurability] = None
        if self.cfg.durability is not None:
            self.attach_durability(self.cfg.durability)
        tele = self.cfg.telemetry
        self.tele_cfg = tele
        self.telemetry: Optional[MetricsRegistry] = None
        self.tracer: Optional[Tracer] = None
        if tele is not None:
            self.telemetry = MetricsRegistry(
                tele, batch_size=self.cfg.batch_size)
            self._salts = self.telemetry.salts
            if tele.trace:
                self.tracer = Tracer()
        # hot-key split set: a fixed-shape runtime input of the tick, so
        # splits swap contents, never shapes
        hot_cap = self.cfg.hot_key_capacity
        self._hot_capacity = (hot_cap if tele is not None
                              and self.cfg.durability is None else 0)
        kd_np = np.int64 if self.key_bits == 64 else np.int32
        self._hot_keys = np.zeros(max(1, self._hot_capacity), kd_np)
        self._hot_valid = np.zeros(max(1, self._hot_capacity), bool)
        self._hot_dev = None
        self._hot_table()

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
        S, kd, dev = self.n_shards, self.key_dtype, self.device

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
        cfg, wf, S = self.cfg, self.wf, self.n_shards
        rh, rs = self.ring.table(self.device)
        hot_keys, hot_valid = self._hot_table()
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
                    recv, dropped = exchange(batch, dshard, S,
                                             self.cap_per_dest)
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
        """One tick.  ``sources``: ``[n_shards, B]``-leading batches.
        Updates ``state`` in place (use the returned one); returns
        ``(state, outputs)`` with ``[n_shards, ...]`` output batches."""
        return self._tick(state, sources)

    def run_chunk(self, state, stacked_sources: Dict[str, EventBatch],
                  n_ticks: Optional[int] = None):
        """T ticks with no host sync between them.

        ``stacked_sources`` leaves are ``[T, n_shards, B, ...]``.
        Returns ``(state, stacked_outputs, info)``; output leaves are
        ``[T, n_shards, ...]`` and ``info['throttle_hits']`` is the
        ``[T, n_shards]`` on-device per-tick trace.  Bitwise equal to T
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
        host read a probe).  Returns ``(state, ticks_run)``."""
        d = 0
        while d < max_ticks:
            sizes = torch.stack([q.size for q in state["queues"].values()])
            if int(sizes.sum().item()) == 0:
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
        the store."""
        if self.cfg.two_choice_threshold:
            raise ValueError("durability requires two_choice_threshold=0 "
                             "(per-key partials are not store-mergeable)")
        self.dur = EngineDurability(cfg, self.wf, self.cfg.queue_capacity,
                                    self.cfg.batch_size,
                                    n_shards=self.n_shards)

    def append_sources(self, tick: int, sources: Dict[str, EventBatch]):
        """Write-ahead: log each shard's row of the ``[n_shards, B]``
        source batches to that shard's WAL (call before the tick runs).

        The host copy is issued here (pinned, behind an event on the
        card); the per-shard slicing and the appends run on the
        durability writer thread, so the dispatch path pays only the
        enqueue.  A stream with no valid event on a shard is not logged
        for that shard."""
        staged, event = stage_sources(sources)
        n_shards, dur = self.n_shards, self.dur

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
                for s in range(self.n_shards)}

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
            for sh in range(self.n_shards)]) for up in self.wf.updaters()]
        for up, toks in tokens:
            rows = [flush_mod.finish_dirty_snapshot(t) for t in toks]
            keys, ts, vals = (np.concatenate([r[0] for r in rows]),
                              np.concatenate([r[1] for r in rows]),
                              tree_map(lambda *v: np.concatenate(v),
                                       *[r[2] for r in rows]))
            dur.flusher.flush_rows(up.name, keys, ts, vals, up.ttl)
        dur.record_frontier(tick, meta=meta)
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
        ``StateHandle``) is republished after every chunk."""
        if self.cfg.autoscale is not None:
            raise NotImplementedError(
                f"DistConfig.autoscale: {ELASTICITY_TODO}")
        return self._run_span(state, source_fn, n_ticks,
                              start_tick=start_tick, handle=handle)

    def _run_span(self, state, source_fn, n_ticks: int, *,
                  start_tick: int = 0, handle=None):
        outputs: List[Dict[str, Any]] = []
        src_t, end = start_tick, start_tick + n_ticks
        eng_tick = int(state["tick"].max().item()) \
            if self.dur is not None else 0
        observe = self.telemetry is not None
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
                if self.dur is not None and self.dur.due(
                        eng_tick, self._shard_tables(state)):
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
        self.tick_cursor = src_t
        if self.dur is not None:
            with self._span("wal_fence"):
                self.dur.fence()
        return state, outputs

    def run_durable(self, state, source_fn, n_ticks: int, *,
                    start_tick: int = 0):
        """Durable host driver: ``source_fn(tick)`` returns ``[n_shards,
        B]``-leading source batches.  Returns ``(state,
        next_source_tick)``; a thin wrapper over :meth:`run`."""
        assert self.dur is not None, "attach_durability first"
        state, _ = self.run(state, lambda t, _mx: source_fn(t), n_ticks,
                            start_tick=start_tick)
        return state, self.tick_cursor

    def recover(self, *, frontier=None):
        """Rebuild the stacked state after losing any subset of shards:
        flushed slates are re-inserted on whatever shard the *current*
        ring routes them to (so a dead shard's keys land on survivors),
        then each shard's WAL suffix replays through the tick, which
        re-routes every replayed event with the current ring.  The log's
        batches come back on the CPU and move to the engine's device."""
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
        # a frontier from a larger shard set: the extra shards' WAL
        # suffixes replay too, re-routed by the current ring
        extra_wals = []
        if len(offs) > len(dur.wals):
            from repro_torch.slates.wal import WriteAheadLog
            extra_wals = [WriteAheadLog(dur.cfg.wal_path(s),
                                        sync=dur.cfg.sync_wal)
                          for s in range(len(dur.wals), len(offs))]

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
                shard_of = self.ring.owners(ks, _salt(up.name))
                t = state["tables"][up.name]
                local = [_row(t, sh) for sh in range(self.n_shards)]
                for sh in range(self.n_shards):
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
                for tk, by_shard in merge_replay_ticks(
                        list(dur.wals) + extra_wals, offs):
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

    # ---- failure (host side; the master of paper section 4.3) ----
    def fail_shard(self, state, shard: int):
        """Machine crash: re-route the ring; the dead shard's unflushed
        slates and queued events are lost (paper semantics).  The ring
        keeps its shape, so nothing else changes.  Updates ``state`` in
        place and returns it."""
        self.ring.fail(shard)
        self._upload_ring()
        for q in state["queues"].values():
            for leaf in pytree.tree_leaves(q):
                leaf[shard].zero_()
        for t in state["tables"].values():
            t.keys[shard].fill_(tbl.EMPTY)
            t.dirty[shard].zero_()
        return state

    @property
    def active_shards(self) -> List[int]:
        return [int(s) for s in np.nonzero(self.ring.alive)[0]]

    def shard_load(self, state) -> np.ndarray:
        """Per-shard pressure signal from the queue stats: high-water
        marks + backlog, drops weighted heavier."""
        load = np.zeros(self.n_shards)
        for q in state["queues"].values():
            g = lambda x: x.cpu().numpy().astype(np.float64)
            load += g(q.peak) + g(q.size) + 4.0 * g(q.dropped)
        return load

    # ---- live elasticity: ROADMAP queue 1 item 15b ----
    def scale(self, state, new_n_shards: int, *, drain_max: int = 64):
        raise NotImplementedError(ELASTICITY_TODO)

    def add_shards(self, state, k: int, *, drain_max: int = 64):
        raise NotImplementedError(ELASTICITY_TODO)

    def remove_shards(self, state, shards, *, drain_max: int = 64):
        raise NotImplementedError(ELASTICITY_TODO)

    def rebalance(self, state, **kwargs):
        raise NotImplementedError(ELASTICITY_TODO)

    def clear_split(self, state, *, drain_max: int = 64):
        raise NotImplementedError(ELASTICITY_TODO)

    def compact(self, state, **kwargs):
        raise NotImplementedError(ELASTICITY_TODO)

    def _reconfigure(self, state, **kwargs):
        raise NotImplementedError(ELASTICITY_TODO)

    # ---- runtime hot-key splitting (DESIGN.md 13.4) ----
    def split_keys(self, state, keys):
        """Live hotspot relief for heavy-hitter keys (paper Example 6 at
        run time): register ``keys`` in the hot set so their events
        spread over the key's primary *and* secondary ring shard;
        ``read_slate`` merges the partials with the updater's combine.
        A content-only swap of a fixed-shape set, in effect from the
        next tick.  Returns ``(state, None)``.  Undoing a split
        (``clear_split``, which migrates the partials) is item 15b."""
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
        g = lambda x: x.cpu().numpy()
        return {
            "tick": int(g(state["tick"]).max()),
            "exchange_dropped": int(g(state["exchange_dropped"]).sum()),
            "throttle_hits": int(g(state["throttle_hits"]).sum()),
            "deferred": int(g(state["deferred"]).sum()),
            "processed": {k: int(g(v).sum())
                          for k, v in state["processed"].items()},
            "queue_dropped": {k: int(g(q.dropped).sum())
                              for k, q in state["queues"].items()},
            "table_occupancy": {k: int(g(t.occupancy()).sum())
                                for k, t in state["tables"].items()},
        }

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
            vals = []
            t = state["tables"][updater]
            q = karr.to(self.device)
            for s in dict.fromkeys(shards):
                local = _row(t, s)
                slot, found = lk_ops.lookup_slots(local.keys, q,
                                                  local.capacity)
                if bool(found[0].item()):
                    i = int(slot[0].item())
                    vals.append(tree_map(
                        lambda v: v[i].to("cpu", copy=True), local.vals))
        if not vals:
            return None
        out = vals[0]
        if len(vals) > 1:
            combine = merge or self.wf.by_name[updater].combine
            for v in vals[1:]:
                out = combine(out, v)
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
            for s in range(self.n_shards):
                local = _row(t, s)
                found, r = lk_ops.lookup_tree(local.keys, local.vals, q,
                                              impl=impl,
                                              capacity=local.capacity)
                m = (found & (prim == s)).to(torch.int32)
                if with_sec:
                    m = m | ((found & (sec_eff == s)).to(torch.int32) << 1)
                masks.append(m)
                rows.append(r)
            mask = torch.stack(masks).cpu().numpy()
            rows = tree_map(lambda *xs: torch.stack(xs).cpu(), *rows)
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
