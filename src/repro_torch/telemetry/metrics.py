"""Windowed load metrics from window-boundary device reads (port of
``repro.telemetry.metrics``).

The tick stays sync-free: at a window boundary ``begin_observe`` starts
one copy of a small aggregate tree to the host and ``finish_observe``,
called after the next chunk is dispatched, waits for it and diffs it
against the previous window.  Readings are *window* quantities (deltas
over the ticks since the last observe), smoothed into EMAs.

``observe_raw`` is the engine-agnostic core; ``observe`` adapts a
stream engine and, when the state carries a count-min sketch, attaches
heavy-hitter estimates.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.event import tree_map
from repro_torch.telemetry import latency as lat_mod
from repro_torch.telemetry import sketch as sk_mod


@dataclass
class TelemetryConfig:
    """Knobs for the device sketch + the metrics window."""

    # depth 2 x width 2048 trades hash rows for row width: the scatter
    # cost in the tick is depth*B updates, while heavy-hitter *ranking*
    # (telemetry's job, unlike a tight frequency oracle) only needs the
    # error bound e*N/width to stay far under the skew threshold.
    # Raise depth for tighter per-key estimates.
    depth: int = 2            # count-min hash rows
    width: int = 2048         # counters per row
    sample: int = 128         # key-sample ring size (heavy-hitter cands)
    # countmin / histogram backend (kernels/*/ops): "auto" (the CUDA
    # kernel on a CUDA device, the plain version on the CPU), "cuda",
    # "ref"
    impl: str = "auto"
    window: int = 8           # source ticks per metrics/decision window
    # sketch aging per window.  0 (default) hard-resets: counters hold
    # exactly one window, so heavy-hitter shares are exact.  >0 keeps a
    # decayed residue (steady state ~1/(1-decay) windows) for smoother
    # estimates — shares are normalized by that factor.
    decay: float = 0.0
    alpha: float = 0.5        # EMA smoothing of windowed readings
    top_k: int = 8            # heavy hitters reported per window
    seed: int = 0x7E1E        # sketch salt seed
    # latency observability (DESIGN.md 18): power-of-two event-latency
    # buckets per updater arc, updated inside the tick.  0
    # disables the histogram state entirely.
    latency_buckets: int = 32
    trace: bool = False       # host-side span tracer on the drive loop
    control_log: Optional[str] = None  # autoscaler decision JSONL path


@dataclass
class TelemetryReport:
    """One window's view of the running engine (all arrays [n_shards];
    the single-shard engine reports shape [1])."""

    tick: int                     # engine tick at the snapshot
    ticks: int                    # ticks covered by this window
    n_shards: int
    active: List[int]             # active shard ids
    events: np.ndarray            # events processed this window
    events_per_tick: np.ndarray   # EMA of events/tick
    queue_depth: np.ndarray       # backlog right now (sum over operators)
    queue_peak_delta: np.ndarray  # high-water growth this window
    dropped_delta: np.ndarray     # drops this window (queues + exchange)
    occupancy: np.ndarray         # slate rows resident (sum over tables)
    pressure: np.ndarray          # EMA normalized load (see `observe_raw`)
    heavy_hitters: List[Tuple[int, int, float]]  # (key, est, share)
    migration_pause_s: float      # EMA of reconfigure pause seconds
    # trailing fields default so older constructors stay valid
    window_s: float = 0.0         # wall seconds since the last observe
    migration_bytes_moved: float = 0.0  # EMA of bytes per reconfigure
    # overload visibility (DESIGN.md section 16): shed = ingest dropped
    # at admission (throttle hits / shed requests), deferred = run tails
    # re-queued by sequential hotspot backpressure — both this window
    shed_delta: Any = 0.0         # [n_shards] when the engine reports it
    deferred_delta: Any = 0.0
    # end-to-end latency (DESIGN.md section 18): quantiles interpolated
    # from the windowed device-histogram deltas, pooled over arcs; the
    # per-arc p99 keeps the queue-delay breakdown ("which arc's queue
    # is eating the latency").  All in source ticks.
    event_latency_p50: float = 0.0
    event_latency_p90: float = 0.0
    event_latency_p99: float = 0.0
    queue_delay_p99: Any = field(default_factory=dict)
    recovery_replay_s: float = 0.0  # last recover() restore+replay secs

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe form (the HTTP status surface)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
        return out


class MetricsRegistry:
    """EMA windows over boundary readings for one engine.

    Shape-agnostic: per-shard array sizes are taken from each reading,
    and a shape change (physical grow) or an explicit :meth:`rebase`
    restarts the window marks — deltas never span a migration, whose
    counter resets would otherwise read as negative load.
    """

    def __init__(self, cfg: TelemetryConfig, *, batch_size: int):
        self.cfg = cfg
        self.batch_size = max(1, batch_size)
        self.salts = sk_mod.make_salts(cfg.depth, cfg.seed)
        self.last: Optional[TelemetryReport] = None
        self._mark: Optional[Dict[str, Any]] = None
        self._ema_ev: Optional[np.ndarray] = None
        self._ema_pressure: Optional[np.ndarray] = None
        self._pause_ema = 0.0
        self._bytes_ema = 0.0
        self._obs_t: Optional[float] = None
        self._recovery_s = 0.0
        # cumulative per-arc latency histograms from the last boundary
        # read (arc -> {"counts", "sum"}) — the /metrics exposition
        # renders these as native Prometheus _bucket/_sum/_count series
        self.hist_cum: Dict[str, Any] = {}

    # ---- engine-agnostic core ---------------------------------------
    def observe_raw(self, *, tick: int, events: np.ndarray,
                    queue_depth: np.ndarray, queue_peak: np.ndarray,
                    dropped: np.ndarray, occupancy: np.ndarray,
                    active: Sequence[int],
                    heavy: List[Tuple[int, int]] = (),
                    shed: Optional[np.ndarray] = None,
                    deferred: Optional[np.ndarray] = None,
                    hist: Optional[Dict[str, Any]] = None
                    ) -> TelemetryReport:
        """Fold one boundary reading (cumulative counters) into the
        window state and return the report.  ``events`` / ``queue_peak``
        / ``dropped`` — and, when given, ``shed`` / ``deferred`` — are
        lifetime counters; this diffs them against the previous
        reading."""
        events = np.asarray(events, np.float64)
        queue_depth = np.asarray(queue_depth, np.float64)
        queue_peak = np.asarray(queue_peak, np.float64)
        dropped = np.asarray(dropped, np.float64)
        occupancy = np.asarray(occupancy, np.float64)
        shed = np.zeros_like(events) if shed is None \
            else np.asarray(shed, np.float64)
        deferred = np.zeros_like(events) if deferred is None \
            else np.asarray(deferred, np.float64)
        n = events.shape[0]
        m = self._mark
        if m is None or m["events"].shape != events.shape:
            m = {"tick": tick, "events": events, "peak": queue_peak,
                 "dropped": dropped, "shed": shed, "deferred": deferred,
                 "hist": hist}
        if self._ema_ev is None or self._ema_ev.shape != events.shape:
            # EMAs survive a same-shape rebase: only the *window marks*
            # restart at migrations — zeroing smoothed pressure there
            # would feed artificially low readings into the controller's
            # streaks right when hysteresis matters most
            self._ema_ev = np.zeros(n)
            self._ema_pressure = np.zeros(n)
        dt = max(1, tick - m["tick"])
        ev_d = np.clip(events - m["events"], 0.0, None)
        peak_d = np.clip(queue_peak - m["peak"], 0.0, None)
        drop_d = np.clip(dropped - m["dropped"], 0.0, None)
        shed_d = np.clip(shed - m.get("shed", shed), 0.0, None)
        def_d = np.clip(deferred - m.get("deferred", deferred), 0.0, None)
        # normalized load: throughput share of batch capacity, plus
        # standing backlog and (heavily weighted) drops — a shard at
        # pressure ~1 is saturated, >1 is shedding
        pressure = (ev_d / dt + queue_depth + 4.0 * drop_d) \
            / self.batch_size
        a = self.cfg.alpha
        self._ema_ev = a * (ev_d / dt) + (1 - a) * self._ema_ev
        self._ema_pressure = a * pressure + (1 - a) * self._ema_pressure
        total = float(ev_d.sum())
        # a decaying sketch holds ~1/(1-decay) windows of counts at
        # steady state while `total` covers one window — normalize so
        # the skew threshold compares like with like
        norm = total / max(1e-9, 1.0 - self.cfg.decay) \
            if 0.0 < self.cfg.decay < 1.0 else total
        hh = [(k, est, min(1.0, est / norm) if norm else 0.0)
              for k, est in heavy]
        # latency quantiles from windowed histogram deltas: pooled over
        # arcs for the end-to-end figure, per-arc for queue-delay p99
        nb = self.cfg.latency_buckets
        lat_p = [0.0, 0.0, 0.0]
        arc_p99: Dict[str, float] = {}
        if hist and nb > 0:
            mh = m.get("hist") or {}
            pooled = None
            for a, h in hist.items():
                cum = np.asarray(h["counts"], np.float64)
                prev = mh.get(a)
                d = np.clip(cum - np.asarray(prev["counts"],
                                             np.float64), 0.0, None) \
                    if prev is not None \
                    and np.shape(prev["counts"]) == cum.shape \
                    else np.zeros_like(cum)
                arc_p99[a] = lat_mod.quantile(d, 0.99, n_buckets=nb)
                pooled = d if pooled is None else pooled + d
            if pooled is not None:
                lat_p = lat_mod.quantiles(pooled, (0.5, 0.9, 0.99),
                                          n_buckets=nb)
            self.hist_cum = hist
        self._mark = {"tick": tick, "events": events, "peak": queue_peak,
                      "dropped": dropped, "shed": shed,
                      "deferred": deferred, "hist": hist}
        now = time.perf_counter()
        window_s = (now - self._obs_t) if self._obs_t is not None else 0.0
        self._obs_t = now
        self.last = TelemetryReport(
            tick=tick, ticks=dt, n_shards=n, active=list(active),
            events=ev_d, events_per_tick=self._ema_ev.copy(),
            queue_depth=queue_depth, queue_peak_delta=peak_d,
            dropped_delta=drop_d, occupancy=occupancy,
            pressure=self._ema_pressure.copy(), heavy_hitters=hh,
            migration_pause_s=self._pause_ema,
            window_s=window_s,
            migration_bytes_moved=self._bytes_ema,
            shed_delta=shed_d, deferred_delta=def_d,
            event_latency_p50=lat_p[0], event_latency_p90=lat_p[1],
            event_latency_p99=lat_p[2], queue_delay_p99=arc_p99,
            recovery_replay_s=self._recovery_s)
        return self.last

    # ---- stream-engine adapter --------------------------------------
    def observe(self, engine, state) -> TelemetryReport:
        """One boundary reading of a stream engine: one copy of the
        aggregate tree to the host, then ``observe_raw``.  Heavy hitters
        are estimated from the state's sketch when present."""
        return self.finish_observe(self.begin_observe(engine, state))

    def begin_observe(self, engine, state):
        """Phase 1 of the double-buffered boundary reading: assemble the
        aggregate tree and start its copy to the host.  Returns a pending
        token; the run loop resolves it with :meth:`finish_observe` after
        the *next* chunk is dispatched, so the transfer overlaps device
        work (one-chunk report lag) and the host never waits inside a
        tick.

        Ticks update the state in place.  On a CUDA device the copy into
        pinned host memory is enqueued on the current stream before any
        later tick's kernels, so stream order keeps it from seeing them
        (no device-side copy is needed) and a recorded event marks its
        end.  On the CPU the next chunk runs at once, so the tree is
        copied here."""
        tree = self._tree(engine, state, with_heavy=True)
        if engine.device.type != "cuda":
            return engine, tree_map(torch.clone, tree), None
        host = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            .copy_(t, non_blocking=True), tree)
        done = torch.cuda.Event()
        done.record()
        return engine, host, done

    def finish_observe(self, pending) -> TelemetryReport:
        """Phase 2: wait for the transfer and fold the reading into the
        window state (the ``observe_raw`` path)."""
        engine, tree, done = pending
        if done is not None:
            done.synchronize()
        host = tree_map(lambda t: t.numpy(), tree)
        (tick, events, qsize, qpeak, dropped, occ, heavy,
         active, shed, deferred, hist) = self._post(engine, host,
                                                    with_heavy=True)
        return self.observe_raw(
            tick=tick, events=events, queue_depth=qsize,
            queue_peak=qpeak, dropped=dropped, occupancy=occ,
            active=active, heavy=heavy, shed=shed, deferred=deferred,
            hist=hist)

    def _tree(self, engine, state, *, with_heavy: bool):
        upd = {u.name for u in engine.wf.updaters()}
        tree = {
            "tick": state["tick"],
            "proc": {k: v for k, v in state["processed"].items()
                     if k in upd},
            "qsize": {k: q.size for k, q in state["queues"].items()},
            "qpeak": {k: q.peak for k, q in state["queues"].items()},
            "qdrop": {k: q.dropped for k, q in state["queues"].items()},
            "occ": {k: t.occupancy() for k, t in state["tables"].items()},
        }
        if "exchange_dropped" in state:
            tree["exdrop"] = state["exchange_dropped"]
        if "throttle_hits" in state:
            tree["shed"] = state["throttle_hits"]
        if "deferred" in state:
            tree["deferred"] = state["deferred"]
        if with_heavy and "sketch" in state:
            tree["sk"] = state["sketch"]
        if "lat_hist" in state:
            tree["hist"] = state["lat_hist"]
        # a multi-rank engine's ranks each hold a block of shards: one
        # collective gives every rank the whole tree
        gather = getattr(engine, "gather_tree", None)
        return gather(tree) if gather is not None else tree

    def _read(self, engine, state, *, with_heavy: bool):
        tree = self._tree(engine, state, with_heavy=with_heavy)
        host = tree_map(lambda t: t.cpu().numpy(), tree)   # one sync
        return self._post(engine, host, with_heavy=with_heavy)

    def _post(self, engine, host, *, with_heavy: bool):
        def shards(x):
            return np.atleast_1d(np.asarray(x, np.float64))

        def summed(d):
            out = None
            for v in d.values():
                v = shards(v)
                out = v if out is None else out + v
            return out if out is not None else np.zeros(1)

        tick = int(np.max(np.asarray(host["tick"])))
        events = summed(host["proc"])
        dropped = summed(host["qdrop"])
        if "exdrop" in host:
            dropped = dropped + shards(host["exdrop"])
        heavy = []
        if "sk" in host:
            sk = host["sk"]
            counts = np.asarray(sk["counts"])
            sample = np.asarray(sk["sample"])
            if counts.ndim == 2:               # single-shard engine
                counts, sample = counts[None], sample[None]
            n_tot = np.atleast_1d(np.asarray(sk["sample_n"]))
            agg = counts.sum(axis=0)           # global heat across shards
            cand = np.unique(np.concatenate(
                [sk_mod.candidates(sample[s], int(n_tot[s]))
                 for s in range(sample.shape[0])]) if sample.shape[0]
                else np.zeros(0, np.int32))
            if len(cand):
                est = sk_mod.estimate(agg, cand, self.salts)
                order = np.argsort(-est, kind="stable")[:self.cfg.top_k]
                heavy = [(int(cand[i]), int(est[i])) for i in order]
        active = getattr(engine, "active_shards", None)
        if active is None:
            active = list(range(events.shape[0]))
        shed = shards(host["shed"]) if "shed" in host else None
        deferred = shards(host["deferred"]) if "deferred" in host \
            else None
        hist = None
        if "hist" in host:
            # per-arc [1, W] rows (leading shard dim on the distributed
            # engine) -> one global [W] row + total latency sum per arc
            hist = {}
            for a, h in host["hist"].items():
                c = np.asarray(h["counts"])
                w = c.shape[-1]
                hist[a] = {"counts": c.reshape(-1, w).sum(axis=0),
                           "sum": float(np.asarray(h["sum"]).sum())}
        return (tick, events, summed(host["qsize"]),
                summed(host["qpeak"]), dropped, summed(host["occ"]),
                heavy, active, shed, deferred, hist)

    # ---- window management ------------------------------------------
    def rebase(self, engine, state):
        """Restart the window marks after a migration (queue peaks and
        shard shapes may have changed): a fresh counter snapshot only —
        no report, no heavy-hitter estimation, and the EMAs are left
        untouched (folding an artificial post-drain zero reading into
        them would bias the controller toward premature scale-down)."""
        (tick, events, _, qpeak, dropped, _, _, _, shed, deferred,
         hist) = self._read(engine, state, with_heavy=False)
        z = np.zeros_like(events)
        self._mark = {"tick": tick, "events": events, "peak": qpeak,
                      "dropped": dropped,
                      "shed": z if shed is None else shed,
                      "deferred": z if deferred is None else deferred,
                      "hist": hist}

    def note_recovery(self, seconds: float):
        """Record the last ``recover()`` wall time (restore + WAL
        replay across shards) — surfaced as ``recovery_replay_s`` on
        the report; the migration path's ``pause_s`` equivalent for
        the crash-recovery path."""
        self._recovery_s = float(seconds)

    def note_pause(self, seconds: float, bytes_moved: int = 0):
        """Record a reconfigure pause and the payload it re-homed
        (EMAs; surfaced on the report — the controller sizes its
        cooldown from the pause, relative to the observed wall-clock
        window, instead of a fixed constant)."""
        a = self.cfg.alpha
        self._pause_ema = a * float(seconds) + (1 - a) * self._pause_ema
        self._bytes_ema = a * float(bytes_moved) \
            + (1 - a) * self._bytes_ema
