"""The multi-shard engine over the ranks of a gloo group, played the same
way on one process (no group) and on each of several ranks, so the
tests compare the two bitwise.  Imports no JAX.

    python tests/_ranks_worker.py STORE RANK WORLD OUT GROUP DIR

joins a gloo world of WORLD ranks through the ``FileStore`` STORE, plays
every scenario of GROUP (``engine`` or ``elastic``) on 8 shards spread
over the ranks (durable runs under DIR), and on rank 0 pickles the
results to OUT.  ``play(group, make, base)`` is what both sides call:
``make(ops, shards, axes, **cfg)`` builds the engine (on the CPU, with
or without the group), and every result is a whole-engine view (the
ranks' blocks gathered), so a rank's results equal one process's.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as tdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.durability import DurabilityConfig  # noqa: E402
from repro_torch.core.engine import StateHandle  # noqa: E402
from repro_torch.core.event import EventBatch  # noqa: E402
from repro_torch.core.operators import (AssociativeUpdater,  # noqa: E402
                                        Mapper, SequentialUpdater)
from repro_torch.core.workflow import Workflow  # noqa: E402
from repro_torch.slates.flush import FlushConfig, FlushPolicy  # noqa: E402
from repro_torch.telemetry import TelemetryConfig  # noqa: E402
from tests import _dist_ref as ref  # noqa: E402

VSPEC = {"x": ((), torch.int32)}
VF = {"x": ((), torch.float32)}
SHARDS = 8
# the rank scenarios' feeds: the reference's, at the rank tests' sizes
COUNT, CHUNK, SLACK, FAIL, TWO, RUN, SPLIT = (
    ref.COUNT, ref.CHUNK, ref.SLACK, ref.FAIL, ref.TWO, ref.RUN,
    dict(ref.SPLIT, shards=SHARDS))
DURABLE_TICKS, DURABLE_CRASH, DURABLE_EVERY = (ref.DURABLE_TICKS,
                                               ref.DURABLE_CRASH,
                                               ref.DURABLE_EVERY)
READ_KEYS, LOOP_KEYS = ref.READ_KEYS, ref.LOOP_KEYS


# ---- the workflows (tests/test_torch_engine.py's, without JAX) ----
class PassThrough(Mapper):
    name = "M1"
    subscribes = ("S1",)
    in_value_spec = VSPEC
    out_streams = {"S2": VSPEC}

    def map_batch(self, batch):
        return {"S2": EventBatch(sid=batch.sid, ts=batch.ts + 1,
                                 key=batch.key, value=batch.value,
                                 valid=batch.valid)}


class Counting(AssociativeUpdater):
    name = "U1"
    subscribes = ("S2",)
    in_value_spec = VSPEC
    out_streams = {}
    table_capacity = 512

    def slate_spec(self):
        return {"count": ((), torch.int32), "sum": ((), torch.float32)}

    def lift(self, batch):
        return {"count": torch.ones_like(batch.key, dtype=torch.int32),
                "sum": batch.value["x"].to(torch.float32)}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"], "sum": a["sum"] + b["sum"]}

    merge = combine


class SumCounting(Counting):
    sum_mergeable = True


class MaxCounting(Counting):
    name = "U3"
    monoid = "max"

    def lift(self, batch):
        return {"count": batch.value["x"].clone(),
                "sum": batch.value["x"].to(torch.float32)}

    def combine(self, a, b):
        return {k: torch.maximum(a[k], b[k]) for k in a}

    merge = combine


class LastValue(SequentialUpdater):
    name = "U2"
    subscribes = ("S2",)
    in_value_spec = VSPEC
    out_streams = {"S3": VSPEC}
    table_capacity = 512
    max_run = 8

    def slate_spec(self):
        return {"last": ((), torch.int32), "n": ((), torch.int32)}

    def step(self, slates, ev):
        new = {"last": ev["value"]["x"], "n": slates["n"] + 1}
        return new, {"S3": {"key": ev["key"], "value": {"x": new["n"]},
                            "emit": True}}


class Count1(AssociativeUpdater):
    """A count on S1."""
    name = "U1"
    subscribes = ("S1",)
    in_value_spec = VSPEC
    out_streams = {}
    table_capacity = 512

    def slate_spec(self):
        return {"count": ((), torch.int32)}

    def lift(self, b):
        return {"count": torch.ones_like(b.key, dtype=torch.int32)}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"]}

    merge = combine


class ECounter(AssociativeUpdater):
    """The elasticity scenarios' counter: count and f32 sum of x on S1."""
    name = "U1"
    subscribes = ("S1",)
    in_value_spec = VF
    out_streams = {}
    table_capacity = 1024
    sum_mergeable = True

    def slate_spec(self):
        return {"count": ((), torch.int32), "sum": ((), torch.float32)}

    def lift(self, b):
        return {"count": torch.ones_like(b.key, dtype=torch.int32),
                "sum": b.value["x"]}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"], "sum": a["sum"] + b["sum"]}

    merge = combine


class ECounter2(ECounter):
    name = "U2"


def count_ops():
    return (PassThrough(), Counting(), LastValue())


# ---- feeding and reading ----
def tb(d):
    """A stacked ``[S, B]`` source batch from a feed's numpy arrays."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return EventBatch(sid=t(np.zeros(d["key"].shape, np.int32)),
                      ts=t(d["ts"]), key=t(d["key"]), value={"x": t(d["x"])},
                      valid=t(d["valid"]))


def eb(keys, xs, t, n):
    """``ref.elastic_feed``'s global batch as ``[n, B / n]``."""
    k = keys.reshape(n, -1)
    return EventBatch(sid=torch.zeros(k.shape, dtype=torch.int32),
                      ts=torch.full(k.shape, t, dtype=torch.int32),
                      key=torch.from_numpy(k.copy()),
                      value={"x": torch.from_numpy(xs.reshape(n, -1).copy())},
                      valid=torch.ones(k.shape, dtype=torch.bool))


def host(eng, st):
    """The whole engine state in plain numpy (every rank's block), copied:
    a CPU state's numpy form shares its memory."""
    return _copy(convert.state_to_numpy(eng.gather_tree(st)))


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree)


def plain_row(r):
    return None if r is None else {k: v.numpy().copy() for k, v in r.items()}


def reads(eng, st, updater, keys=READ_KEYS, loop_keys=LOOP_KEYS):
    return {"looped": [plain_row(eng.read_slate(st, updater, int(k)))
                       for k in loop_keys],
            "batched": [plain_row(r) for r in
                        eng.read_slates(st, updater, keys)]}


def outputs(eng, o):
    return {s: convert.to_plain(eng.gather_tree(b)) for s, b in o.items()}


def steps(eng, fs, st=None):
    st = eng.init_state() if st is None else st
    outs = []
    for d in fs:
        st, o = eng.step(st, {"S1": tb(d)})
        outs.append(outputs(eng, o))
    return st, outs


def report(rep):
    return ref.report_fields(rep)


# ---- the engine scenarios (tests/test_torch_ranks.py) ----
def sc_count(make, base):
    eng = make(count_ops(), batch_size=64, queue_capacity=512)
    st, outs = steps(eng, ref.feeds(**COUNT))
    st, drained = eng.drain(st)
    return dict(state=host(eng, st), stats=eng.stats(st), outputs=outs,
                drained=drained, reads=reads(eng, st, "U1"),
                reads_u2=reads(eng, st, "U2", loop_keys=LOOP_KEYS[:4]))


def sc_grid(make, base):
    eng = make(count_ops(), shards=(2, 4), axes=("pod", "data"),
               batch_size=64, queue_capacity=512)
    st, _ = steps(eng, ref.feeds(**COUNT))
    st, drained = eng.drain(st)
    return dict(state=host(eng, st), stats=eng.stats(st), drained=drained)


def sc_chunk(make, base):
    eng = make((PassThrough(), SumCounting(), MaxCounting()), batch_size=64,
               queue_capacity=512, fused="ref")
    fs = ref.feeds(**CHUNK)
    empty = [dict(d, valid=np.zeros_like(d["valid"]), ts=d["ts"] + 900)
             for d in fs[:4]]
    stack = lambda ds: D._stack([tb(d) for d in ds])
    st, outs, info = eng.run_chunk(eng.init_state(), {"S1": stack(fs)})
    hits = info["throttle_hits"].transpose(0, 1)
    st, _, _ = eng.run_chunk(st, {"S1": stack(empty)})
    return dict(state=host(eng, st), stats=eng.stats(st),
                hits=eng.gather_tree(hits).numpy())


def sc_run(make, base):
    eng = make((PassThrough(), Counting()), batch_size=64,
               queue_capacity=512, chunk_size=4,
               telemetry=TelemetryConfig(width=256, window=4))
    fs = ref.feeds(**RUN)
    st, outs = eng.run(eng.init_state(), lambda t, mx: {"S1": tb(fs[t])},
                       len(fs))
    rep = eng.telemetry.last
    return dict(state=host(eng, st), stats=eng.stats(st),
                n_outputs=len(outs), cursor=eng.tick_cursor,
                report=dict(events=rep.events, heavy=rep.heavy_hitters,
                            queue_depth=rep.queue_depth,
                            dropped=rep.dropped_delta,
                            occupancy=rep.occupancy, tick=rep.tick))


def sc_slack(make, base):
    eng = make((PassThrough(), Counting()), batch_size=64,
               queue_capacity=512, exchange_slack=0.5)
    st, _ = steps(eng, ref.feeds(**SLACK))
    st, _ = eng.drain(st)
    return dict(state=host(eng, st), stats=eng.stats(st),
                cap=eng.cap_per_dest)


def sc_two_choice(make, base):
    eng = make((Count1(),), batch_size=256, queue_capacity=2048,
               exchange_slack=8.0, two_choice_threshold=4, external="S1")
    st, _ = steps(eng, ref.feeds(**TWO))
    st, _ = eng.drain(st, 6)
    return dict(state=host(eng, st), stats=eng.stats(st),
                reads=reads(eng, st, "U1"))


def sc_split(make, base):
    eng = make((Count1(),), batch_size=64, queue_capacity=2048,
               exchange_slack=16.0, hot_key_capacity=8,
               telemetry=TelemetryConfig(width=256), external="S1")
    fs = ref.feeds(**SPLIT)
    st, _ = steps(eng, fs[:3])
    st, _ = eng.split_keys(st, [SPLIT["hot"]])
    st, _ = steps(eng, fs[3:], st)
    for _ in range(4):
        st = eng._step_empty(st)
    return dict(state=host(eng, st), stats=eng.stats(st),
                split_set=eng.split_key_set(), reads=reads(eng, st, "U1"))


def sc_fail(make, base):
    eng = make((PassThrough(), Counting()), batch_size=64,
               queue_capacity=512)
    fs = ref.feeds(**FAIL)
    st, _ = steps(eng, fs[:8])
    st, _ = eng.drain(st)
    before = eng.stats(st)
    st = eng.fail_shard(st, 3)
    failed = host(eng, st)
    st, _ = steps(eng, fs[8:], st)
    st, _ = eng.drain(st)
    return dict(before=before, failed=failed, state=host(eng, st),
                stats=eng.stats(st), reads=reads(eng, st, "U1"))


def durable(make, d):
    return make((PassThrough(), Counting()), batch_size=64,
                queue_capacity=256, durability=DurabilityConfig(
                    dir=d, flush=FlushConfig(policy=FlushPolicy.EVERY_K,
                                             every_k=DURABLE_EVERY)))


def durable_src(t):
    return {"S1": tb(ref.durable_feed(t))}


def crash_run(make, d):
    """The durable feed for ``DURABLE_CRASH`` ticks, then a crash (the
    engine closed, its state dropped)."""
    eng = durable(make, d)
    st, _ = eng.run_durable(eng.init_state(), durable_src, DURABLE_CRASH)
    frontier = eng.dur.frontier.tick
    eng.close()
    return frontier


def recover_run(make, d):
    """Recover ``d`` and run the feed to its end."""
    eng = durable(make, d)
    st = eng.recover()
    recovered = host(eng, st)
    st, nxt = eng.run_durable(st, durable_src,
                              DURABLE_TICKS - DURABLE_CRASH,
                              start_tick=DURABLE_CRASH)
    out = dict(recovered=recovered, state=host(eng, st),
               stats=eng.stats(st), next=nxt,
               frontier=(eng.dur.frontier.tick,
                         list(eng.dur.frontier.wal_offset),
                         eng.dur.frontier.meta),
               slates=reads(eng, st, "U1", keys=np.arange(64,
                                                          dtype=np.int32),
                            loop_keys=LOOP_KEYS[:2]))
    eng.close()
    return out


def sc_durable(make, base):
    """A crash on this side's engine and its recovery here.  Over ranks
    also: the crash copied to ``base/cross_out`` (before its recovery)
    for one process to recover, and a crash of a one-process engine
    (rank 0 alone) recovered on the ranks."""
    d = os.path.join(base, "durable")
    frontier = crash_run(make, d)
    _barrier(make)
    ranks = getattr(make, "group", None) is not None
    if ranks and _rank(make) == 0:
        shutil.copytree(d, os.path.join(base, "cross_out"))
        crash_run(one_card, os.path.join(base, "cross_in"))
    _barrier(make)
    out = dict(crash_frontier=frontier, own=recover_run(make, d))
    if ranks:
        out["cross"] = recover_run(make, os.path.join(base, "cross_in"))
    return out


SERVE_CHUNK = 4
SERVE_PATHS = ref.serve_paths() + ["/status", "/metrics"]


def sc_serve(make, base):
    """``StateHandle.serve`` on ``COUNT``'s run (``run`` in chunks of
    ``SERVE_CHUNK`` ticks).  Over ranks: rank 0 serves, a client thread
    a path of ``SERVE_PATHS`` there reads it again and again while the
    run goes (each answer with the source tick of the drain that served
    it), then one request
    a path is queued after the run and ``close()`` answers them (the
    ``final`` bodies); every rank's server port.  On one process: the
    bodies at every chunk boundary (the run in spans of a chunk) and at
    the end, read directly."""
    eng = make(count_ops(), batch_size=64, queue_capacity=512,
               chunk_size=SERVE_CHUNK)
    fs = ref.feeds(**COUNT)
    src = lambda t, mx: {"S1": tb(fs[t])}
    h = StateHandle(eng, eng.init_state())
    srv = h.serve()
    out = {}
    if getattr(make, "group", None) is None:
        out["at_tick"] = {}
        for t in range(0, len(fs), SERVE_CHUNK):
            h.state, _ = eng.run(h.state, src, SERVE_CHUNK, start_tick=t,
                                 handle=h)
            out["at_tick"][t + SERVE_CHUNK] = {
                p: ref.http_get(srv.port, p) for p in SERVE_PATHS}
        out["final"] = {p: ref.http_get(srv.port, p) for p in SERVE_PATHS}
        h.close()
    else:
        root = _rank(make) == 0
        out["ports"] = D.all_gather_objects(srv.port, make.group)
        live, stop = [], threading.Event()

        def client(p):
            while not stop.is_set():
                live.append((p,) + ref.http_get(srv.port, p))

        readers = [threading.Thread(target=client, args=(p,))
                   for p in SERVE_PATHS] if root else []
        for r in readers:
            r.start()
        def paced(t, mx):
            # every reader's first request waits for the first boundary
            t0 = time.monotonic()
            while root and t == 0 and len(h._queue) < len(SERVE_PATHS):
                assert time.monotonic() - t0 < 60, "readers never queued"
                time.sleep(0.005)
            time.sleep(0.02)
            return src(t, mx)

        h.state, _ = eng.run(h.state, paced, len(fs), handle=h)
        # the readers' last requests answered at the run's end
        stop.set()
        while D.broadcast_object(any(r.is_alive() for r in readers),
                                 make.group):
            h.drain()
            time.sleep(0.01)
        final = {}
        if root:
            askers = [threading.Thread(target=lambda p=p: final.update(
                {p: ref.http_get(srv.port, p)})) for p in SERVE_PATHS]
            for a in askers:
                a.start()
            t0 = time.monotonic()
            while len(h._queue) < len(SERVE_PATHS):   # all queued
                assert time.monotonic() - t0 < 60, "askers never queued"
                time.sleep(0.01)
        h.close()
        if root:
            for a in askers:
                a.join()
        out.update(live=live, final=final)
    out["state"] = host(eng, h.state)
    return out


ENGINE = {"count": sc_count, "grid": sc_grid, "chunk": sc_chunk,
          "run": sc_run, "slack": sc_slack, "two_choice": sc_two_choice,
          "split": sc_split, "fail": sc_fail, "durable": sc_durable,
          "serve": sc_serve}


# ---- the elasticity scenarios (tests/test_torch_ranks_elastic.py) ----
def elastic(make, ops=(ECounter,), **cfg):
    return make(tuple(o() for o in ops), external="S1",
                **{**dict(batch_size=32, queue_capacity=256, fused="off"),
                   **cfg})


def feed_ticks(eng, st, feed, t0=0):
    for t, (keys, xs) in enumerate(feed):
        st, _ = eng.step(st, {"S1": eb(keys, xs, t0 + t, eng.n_shards)})
    return st


def snap(eng, st):
    return dict(state=host(eng, st), stats=eng.stats(st),
                n_shards=eng.n_shards, active=list(eng.active_shards),
                reads=reads(eng, st, "U1", keys=ref.ELASTIC_KEYS,
                            loop_keys=ref.ELASTIC_KEYS[::40]))


def sc_scale(make, base):
    """8 -> 4 -> 8 on the device tier, with a backlog at the leave."""
    eng = elastic(make, (ECounter, ECounter2), batch_size=16,
                  queue_capacity=2048, exchange_slack=16.0)
    # hot keys pile a backlog up on their shards: the leave moves it
    feed = ref.elastic_feed(seed=3, ticks=8, n=128, key_hi=48,
                            hot=tuple(range(8)), p_hot=0.6)
    st = feed_ticks(eng, eng.init_state(), feed[:3])
    st, down = eng.scale(st, 4, drain_max=0)
    mid = snap(eng, st)
    st = feed_ticks(eng, st, feed[3:6], 3)
    st, up = eng.scale(st, 8)
    st = feed_ticks(eng, st, feed[6:], 6)
    st, drained = eng.drain(st, 256)
    return dict(reports=[report(down), report(up)], mid=mid,
                end=snap(eng, st), drained=drained)


def sc_rebalance(make, base):
    eng = elastic(make, batch_size=32, queue_capacity=2048,
                  exchange_slack=16.0, fused="auto")
    feed = ref.elastic_feed(seed=2, ticks=6, n=128, key_hi=1, ones=True,
                            base=7)
    st = feed_ticks(eng, eng.init_state(), feed)
    for _ in range(10):
        st = eng._step_empty(st)
    st, r1 = eng.rebalance(st)
    st, r2 = eng.rebalance(st, weights=np.linspace(0.5, 2.0, SHARDS))
    st, drained = eng.drain(st, 256)
    return dict(reports=[report(r1), report(r2)], end=snap(eng, st),
                weights=np.asarray(eng.ring.weights), drained=drained,
                vnodes=np.asarray(eng.ring.vnode_counts()))


def sc_clear_split(make, base):
    eng = elastic(make, batch_size=64, queue_capacity=2048,
                  exchange_slack=16.0, hot_key_capacity=8,
                  telemetry=TelemetryConfig(width=256))
    feed = ref.elastic_feed(seed=4, ticks=9, n=64, key_hi=32, hot=(7,),
                            p_hot=0.75)
    st = feed_ticks(eng, eng.init_state(), feed[:3])
    st, _ = eng.split_keys(st, [7, 9])
    st = feed_ticks(eng, st, feed[3:], 3)
    split = snap(eng, st)
    st, rep = eng.clear_split(st)
    return dict(split=split, report=report(rep), end=snap(eng, st))


def sc_host_tier(make, base):
    """Grow 8 -> 16 and compact back to 8 (the host tier), then a grow to
    a count the ranks cannot split (10 on 4 ranks) must raise there."""
    eng = elastic(make, (ECounter, ECounter2), compact_threshold=0.0)
    feed = ref.elastic_feed(seed=11, ticks=9, n=64, key_hi=48)
    st = feed_ticks(eng, eng.init_state(), feed[:3])
    st, grow = eng.scale(st, 16)
    st = feed_ticks(eng, st, feed[3:6], 3)
    grown = snap(eng, st)
    st, leave = eng.remove_shards(st, list(range(8, 16)))
    st, comp = eng.compact(st)
    st = feed_ticks(eng, st, feed[6:], 6)
    st, drained = eng.drain(st, 256)
    out = dict(reports=[report(grow), report(leave), report(comp)],
               grown=grown, end=snap(eng, st), drained=drained)
    try:
        eng.scale(st, 10)
        out["grow_10"] = "ran"
    except ValueError as e:
        out["grow_10"] = str(e)
    return out


def sc_policy(make, base):
    """``run`` under an ``AutoscalePolicy``: a leave to 4 and a rejoin at
    declared ticks, a load rebalance every 4 ticks."""
    reps = []
    pol = D.AutoscalePolicy(scale_at={3: 4, 6: 8}, rebalance_every=4,
                            on_change=lambda r: reps.append(report(r)))
    eng = elastic(make, batch_size=16, queue_capacity=1024,
                  exchange_slack=16.0, autoscale=pol)
    feed = ref.elastic_feed(seed=5, ticks=10, n=128, key_hi=40,
                            hot=(3, 11), p_hot=0.4)
    st, _ = eng.run(eng.init_state(), lambda t, mx: {
        "S1": eb(*feed[t], t, eng.n_shards)}, len(feed))
    st, drained = eng.drain(st, 256)
    return dict(reports=reps, end=snap(eng, st), drained=drained,
                weights=np.asarray(eng.ring.weights))


def sc_closed_loop(make, base):
    """The reference's closed-loop square wave (``ref.closed_loop_feed``)
    from 4 shards under a ``LoadAutoscaler`` bounded to 4-8: every rank
    takes rank 0's decision, from the gathered telemetry."""
    reps = []
    G = ref.CLOSED_LOOP["G"]
    ctl = ref_load_autoscaler(reps)
    eng = make((ECounter(),), shards=4, external="S1", batch_size=G // 4,
               queue_capacity=4 * G, fused="off", exchange_slack=8.0,
               telemetry=TelemetryConfig(width=256, alpha=1.0),
               autoscale=ctl)
    trace = []

    def src(t, _mx):
        trace.append(len(eng.active_shards))
        keys, xs, valid = ref.closed_loop_feed(t)
        b = eb(keys, xs, t, eng.n_shards)
        b.valid.copy_(torch.from_numpy(valid.reshape(eng.n_shards, -1)))
        return {"S1": b}

    st, _ = eng.run(eng.init_state(), src, ref.CLOSED_LOOP["ticks"])
    st, drained = eng.drain(st)
    return dict(trace=trace, reports=reps, end=snap(eng, st),
                drained=drained)


def ref_load_autoscaler(reps):
    from repro_torch.telemetry import LoadAutoscaler
    return LoadAutoscaler(high=0.75, low=0.25, window=3, dwell=2,
                          cooldown=1, min_shards=4, max_shards=8,
                          on_change=lambda r: reps.append(report(r)))


def sc_durable_scale(make, base):
    """Durability across a grow (8 -> 16, the host tier: the ranks'
    blocks move and each reopens its block's WALs) and a leave back to 8
    (the device tier), then a crash and the recovery on 8 slots."""
    def build():
        pol = D.AutoscalePolicy(scale_at={3: 16, 7: 8})
        return elastic(make, batch_size=16, queue_capacity=512,
                       exchange_slack=16.0, autoscale=pol,
                       durability=DurabilityConfig(
                           dir=os.path.join(base, "d"),
                           flush=FlushConfig(policy=FlushPolicy.EVERY_K,
                                             every_k=4)))

    feed = ref.elastic_feed(seed=8, ticks=12, n=128, key_hi=64)
    eng = build()
    src = lambda t, mx: {"S1": eb(*feed[t], t, eng.n_shards)}
    st, _ = eng.run(eng.init_state(), src, 10)
    crashed = dict(frontier=(eng.dur.frontier.tick,
                             list(eng.dur.frontier.wal_offset),
                             eng.dur.frontier.meta),
                   n_shards=eng.n_shards, active=list(eng.active_shards))
    eng.close()                             # the crash: the state is lost
    # recovered on 8 slots: the 16 slots' WAL suffixes fold onto them
    eng = build()
    st = eng.recover()
    src = lambda t, mx: {"S1": eb(*feed[t], t, eng.n_shards)}
    st, _ = eng.run(st, src, 2, start_tick=10)
    st, drained = eng.drain(st, 256)
    out = dict(crashed=crashed, end=snap(eng, st), drained=drained)
    eng.close()
    return out


ELASTIC = {"scale": sc_scale, "rebalance": sc_rebalance,
           "clear_split": sc_clear_split, "host_tier": sc_host_tier,
           "policy": sc_policy, "closed_loop": sc_closed_loop,
           "durable_scale": sc_durable_scale}


# ---- playing the scenarios ----
def one_card(ops, shards=SHARDS, axes=("data",), external="S1", **cfg):
    """The no-group engine on the CPU."""
    return _engine(ops, shards, axes, external, None, cfg)


def _engine(ops, shards, axes, external, group, cfg):
    shape = (shards,) if isinstance(shards, int) else shards
    return D.DistributedEngine(
        Workflow(list(ops), external_streams=(external,)),
        D.make_mesh(shape, axes, group=group),
        D.DistConfig(axis_names=axes, **cfg), device="cpu")


def on_group(group):
    def make(ops, shards=SHARDS, axes=("data",), external="S1", **cfg):
        return _engine(ops, shards, axes, external, group, cfg)
    make.group = group
    return make


def _rank(make):
    g = getattr(make, "group", None)
    return 0 if g is None else tdist.get_rank(g)


def _barrier(make):
    g = getattr(make, "group", None)
    if g is not None:
        tdist.barrier(group=g)


def play(group, make, base):
    """Every scenario of ``group`` (``engine`` or ``elastic``); a
    scenario that raises gives its traceback as its result."""
    table = {"engine": ENGINE, "elastic": ELASTIC}[group]
    out = {}
    for name, fn in table.items():
        os.makedirs(os.path.join(base, name), exist_ok=True)
        try:
            out[name] = fn(make, os.path.join(base, name))
        except Exception:
            out[name] = {"error": traceback.format_exc()}
            raise
    return out


def main(argv):
    store, rank, world, out, group, base = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world,
                             timeout=datetime.timedelta(seconds=240))
    try:
        counts0 = dict(D.COLLECTIVES)
        res = play(group, on_group(tdist.group.WORLD), base)
        res["collectives"] = {k: D.COLLECTIVES[k] - counts0[k]
                              for k in counts0}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
