"""The JAX ``DistributedEngine`` side of the port's multi-shard parity
tests, run in ONE subprocess per test file (an 8-device host platform
needs ``XLA_FLAGS`` before JAX starts, so never in the pytest process).

    python tests/_dist_ref.py OUT.pkl GROUP [ARG ...]

runs every reference scenario of GROUP (``engine``, ``ranks``,
``hotspot``, ``durable``, ``elastic``, ``elastic_durable`` or
``closed_loop``) and
pickles their results — states in the plain numpy form
of ``repro_torch.convert.to_plain``, stats, reads, outputs — to OUT.pkl.
The feeds are numpy, made here from seeds (``feeds``), and the port's
tests build the same ones.  Module level imports numpy only.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- scenario parameters, shared with the port's tests ----
COUNT = dict(seed=0, ticks=12, shards=8, per_shard=16, key_hi=64,
             p_valid=0.9)
CHUNK = dict(seed=7, ticks=8, shards=8, per_shard=16, key_hi=64,
             p_valid=1.0)
SLACK = dict(seed=3, ticks=6, shards=8, per_shard=32, key_hi=40,
             p_valid=1.0, hot=3, p_hot=0.5)
FAIL = dict(seed=1, ticks=16, shards=8, per_shard=16, key_hi=64,
            p_valid=1.0)
TWO = dict(seed=0, ticks=10, shards=8, per_shard=16, key_hi=8,
           p_valid=1.0, hot=7, p_hot=1.0)
RUN = dict(seed=5, ticks=12, shards=8, per_shard=16, key_hi=48,
           p_valid=0.9, hot=5, p_hot=0.3)
READS = dict(seed=11, ticks=6, shards=4, per_shard=8, key_hi=64,
             p_valid=1.0)
SPLIT = dict(seed=2, ticks=9, shards=4, per_shard=16, key_hi=32,
             p_valid=1.0, hot=7, p_hot=0.75)
SPLIT_READS = dict(seed=5, ticks=8, shards=4, per_shard=8, key_hi=40,
                   p_valid=1.0, hot=9, p_hot=0.5)
DURABLE = dict(seed=50, ticks=12, shards=8, per_shard=16, key_hi=64,
               p_valid=1.0)
EXCHANGE = dict(seed=9, shards=8, per_shard=64, cap=8)
DURABLE_TICKS, DURABLE_CRASH, DURABLE_EVERY = 12, 9, 4
READ_KEYS = np.arange(-4, 72, dtype=np.int32)    # hits and misses
LOOP_KEYS = READ_KEYS[::4]      # the JAX engine's per-key reads are slow
SERVE_SINGLES = (0, 5, 17, 40, 63, 70)           # 70: never fed


def serve_paths(updater="U1"):
    """The slate reads the serve parity tests make over HTTP: one
    ``/slate`` a key of ``SERVE_SINGLES`` and one ``/slates`` of
    ``READ_KEYS``."""
    return [f"/slate/{updater}/{k}" for k in SERVE_SINGLES] + [
        f"/slates/{updater}?keys=" + ",".join(str(int(k))
                                               for k in READ_KEYS)]


def http_get(port, path, timeout=120):
    """``(status, X-Source-Tick or None, body bytes)`` of ``GET path`` on
    127.0.0.1:``port``, error statuses included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.headers.get("X-Source-Tick"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("X-Source-Tick"), e.read()


# ---- live elasticity: scenarios both packages play through ``play`` ----
# workflows: "U1" = one counter (count + f32 sum of x, 1,024 slots) on S1;
# "U1U2" = two such counters; "fwd" = a forwarding mapper S1 -> S2 (ts +
# 1) in front of the counter on S2.  ``at[t]`` lists the calls made
# before tick t runs, ``after`` the calls after the feed; each call is
# (method, args, kwargs) of the engine, or ("remove_loaded", (k,), kw):
# remove the k shards with the largest backlog.
_BASE = dict(batch_size=32, queue_capacity=256, fused="off")
# the first keys the 4-shard ring homes on shard 3 for U1: hammered, so
# the planned leave of shard 3 has a backlog exactly where it re-homes
LEAVE_HOT = (8, 11, 12, 13)
ELASTIC = {
    # tests/test_elasticity.py::test_scale_2to4_parity_fast
    "scale_2to4": dict(shards=2, ops="U1", cfg=_BASE,
                       feed=dict(seed=0, ticks=6, n=32, key_hi=32),
                       at={3: [("scale", (4,), {})]}),
    # ::test_device_migration_parity_fast, each tier
    "device_tier": dict(shards=4, ops="U1U2",
                        cfg=dict(_BASE, device_migration="auto"),
                        feed=dict(seed=3, ticks=6, n=32, key_hi=48),
                        at={2: [("remove_shards", ([3],), {})],
                            4: [("scale", (4,), {})]}),
    "host_tier": dict(shards=4, ops="U1U2",
                      cfg=dict(_BASE, device_migration="off"),
                      feed=dict(seed=3, ticks=6, n=32, key_hi=48),
                      at={2: [("remove_shards", ([3],), {})],
                          4: [("scale", (4,), {})]}),
    # ::test_grow_compact_grow_roundtrip_fast
    "grow_compact_grow": dict(shards=2, ops="U1",
                              cfg=dict(_BASE, compact_threshold=0.5),
                              feed=dict(seed=11, ticks=9, n=32, key_hi=48,
                                        ones=True),
                              at={2: [("scale", (4,), {})],
                                  5: [("remove_shards", ([2, 3],), {})],
                                  7: [("scale", (4,), {})]}),
    # ::test_planned_leave_with_backlog_stays_on_device_path, each tier
    "leave_backlog_device": dict(
        shards=4, ops="U1", cfg=dict(_BASE, queue_capacity=2048,
                                     device_migration="auto"),
        feed=dict(seed=7, ticks=6, n=128, key_hi=24, hot=LEAVE_HOT,
                  p_hot=0.6),
        at={3: [("remove_shards", ([3],), {"drain_max": 0})]},
        drain=256),
    "leave_backlog_host": dict(
        shards=4, ops="U1", cfg=dict(_BASE, queue_capacity=2048,
                                     device_migration="off"),
        feed=dict(seed=7, ticks=6, n=128, key_hi=24, hot=LEAVE_HOT,
                  p_hot=0.6),
        at={3: [("remove_shards", ([3],), {"drain_max": 0})]},
        drain=256),
    # ::test_remove_shards_loss_free_with_inflight_events, then rejoin
    "inflight_rejoin": dict(
        shards=8, ops="U1", cfg=dict(batch_size=16, queue_capacity=512,
                                     exchange_slack=16.0),
        feed=dict(seed=1, ticks=10, n=128, key_hi=64),
        at={5: [("remove_loaded", (2,), {"drain_max": 0})]},
        empty=40, after=[("scale", (8,), {})]),
    # ::test_rebalance_hot_ring_sheds_load and test_telemetry.py::
    # test_rebalance_window_rebase_back_to_back
    "rebalance_hot": dict(
        shards=8, ops="U1", cfg=dict(batch_size=32, queue_capacity=2048,
                                     exchange_slack=16.0),
        feed=dict(seed=2, ticks=6, n=128, key_hi=1, ones=True, base=7),
        after=[("rebalance", (), {}), ("rebalance", (), {})], empty=40),
    # ::test_multiaxis_pod_data_growth
    "multiaxis": dict(shards=(2, 2), axes=("pod", "data"), ops="U1",
                      cfg=_BASE,
                      feed=dict(seed=9, ticks=8, n=32, key_hi=48, ones=True),
                      at={4: [("scale", (8,), {})]}),
    # ::test_compaction_folds_lifetime_counters (drops, telemetry)
    "compact_fold": dict(
        shards=4, ops="U1", cfg=dict(batch_size=16, queue_capacity=32,
                                     fused="off", compact_threshold=0.0),
        telemetry=dict(window=4, decay=0.5),
        feed=dict(seed=1, ticks=10, n=64, key_hi=200, hot=(3,), p_hot=0.5),
        drain=64, after=[("remove_shards", ([2, 3],), {}),
                         ("compact", (), {}), ("compact", (), {})],
        observe=True),
    # test_telemetry.py::test_split_keys_runtime_exact_counts: a split,
    # then clear_split converges the partials
    "clear_split": dict(
        shards=4, ops="U1", cfg=dict(batch_size=64, queue_capacity=2048,
                                     exchange_slack=16.0,
                                     hot_key_capacity=8),
        telemetry=dict(width=256),
        feed=dict(seed=4, ticks=9, n=64, key_hi=32, hot=(7,), p_hot=0.75),
        at={3: [("split_keys", ([7, 9],), {})]}, empty=20,
        after=[("clear_split", (), {})]),
}
ELASTIC_KEYS = np.arange(-2, 210, dtype=np.int32)


def elastic_feed(seed, ticks, n, key_hi, hot=None, p_hot=0.0, ones=False,
                 base=0):
    """``ticks`` global batches of ``n`` events: (keys, xs float32)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ticks):
        keys = (base + rng.integers(0, key_hi, n)).astype(np.int32)
        if hot is not None:
            keys = np.where(rng.random(n) < p_hot,
                            rng.choice(np.asarray(hot, np.int32), n),
                            keys).astype(np.int32)
        xs = np.ones(n, np.float32) if ones else \
            rng.integers(0, 99, n).astype(np.float32)
        out.append((keys, xs))
    return out


def report_fields(rep):
    """A ``MigrationReport`` as a dict, ``pause_s`` aside (a wall time)."""
    if rep is None:
        return None
    return {f: getattr(rep, f) for f in (
        "n_shards", "active", "drain_ticks", "moved_rows", "moved_events",
        "recompiled", "bytes_moved", "path")}


def play(spec, eng, batch, host, reads):
    """Drive either package's engine through an ``ELASTIC`` scenario.

    ``batch(keys, xs, t, n_shards)`` makes a ``[n_shards, B]`` source
    batch, ``host(state)`` the plain numpy state, ``reads(eng, state,
    keys)`` the batched reads of ``U1``.  Returns the reports, the state
    after each call and at the end, stats, reads and ring facts."""
    reps, snaps, pause = [], [], []

    def call(st, name, args, kw):
        if name == "remove_loaded":
            size = host(st)["queues"]["U1"]["size"]
            loaded = [int(s) for s in np.argsort(size, kind="stable")
                      [-args[0]:]]
            st, rep = eng.remove_shards(st, sorted(loaded), **kw)
        else:
            st, rep = getattr(eng, name)(st, *args, **kw)
        reps.append(report_fields(rep))
        pause.append(None if rep is None else rep.pause_s > 0)
        snaps.append(host(st))
        return st

    st = eng.init_state()
    for t, (keys, xs) in enumerate(elastic_feed(**spec["feed"])):
        for name, args, kw in spec.get("at", {}).get(t, ()):
            st = call(st, name, args, kw)
        st, _ = eng.step(st, {"S1": batch(keys, xs, t, eng.n_shards)})
    if spec.get("drain"):
        st, _ = eng.drain(st, spec["drain"])
    for _ in range(spec.get("empty", 0)):
        st = eng._step_empty(st)
    for name, args, kw in spec.get("after", ()):
        st = call(st, name, args, kw)
    st, drained = eng.drain(st, 256)
    out = dict(reports=reps, pause=pause, snaps=snaps, state=host(st),
               stats=eng.stats(st), drained=drained,
               reads=reads(eng, st, ELASTIC_KEYS),
               n_shards=eng.n_shards, active=list(eng.active_shards),
               vnodes=np.asarray(eng.ring.vnode_counts()),
               weights=np.asarray(eng.ring.weights))
    if spec.get("observe"):
        r = eng.telemetry.observe(eng, st)
        out["observe"] = dict(n_shards=r.n_shards, active=list(r.active),
                              events=np.asarray(r.events),
                              dropped=np.asarray(r.dropped_delta),
                              occupancy=np.asarray(r.occupancy))
    if spec["ops"] == "U1U2":
        out["heat_owners"] = eng.heat_owners(np.arange(256, dtype=np.int32))
    return out


def feeds(seed, ticks, shards, per_shard, key_hi, p_valid=1.0, hot=None,
          p_hot=0.0, t0=0):
    """``ticks`` source dicts of ``[shards, per_shard]`` numpy arrays:
    keys uniform in [0, key_hi) (a ``p_hot`` share set to ``hot``),
    values in [0, 9), ts = the tick, validity with probability
    ``p_valid``."""
    rng = np.random.default_rng(seed)
    out = []
    shape = (shards, per_shard)
    for t in range(t0, t0 + ticks):
        key = rng.integers(0, key_hi, size=shape).astype(np.int32)
        if hot is not None:
            key = np.where(rng.random(shape) < p_hot, hot, key) \
                .astype(np.int32)
        out.append({"key": key,
                    "x": rng.integers(0, 9, size=shape).astype(np.int32),
                    "ts": np.full(shape, t, np.int32),
                    "valid": rng.random(shape) < p_valid})
    return out


def durable_feed(t, shards=8, per_shard=16):
    """Tick t of the durable runs (``tests/test_recovery.py``'s feed):
    its own seed, so a replay regenerates it."""
    rng = np.random.default_rng(50 + t)
    key = rng.integers(0, 64, size=(shards, per_shard)).astype(np.int32)
    return {"key": key, "x": key % 7,
            "ts": np.full(key.shape, t, np.int32),
            "valid": np.ones(key.shape, bool)}


def exchange_inputs(seed, shards, per_shard, cap):
    """A stacked batch and skewed destinations for the bare exchange:
    60 % of the events go to shard 2, so its buckets overflow."""
    rng = np.random.default_rng(seed)
    shape = (shards, per_shard)
    dest = np.where(rng.random(shape) < 0.6, 2,
                    rng.integers(0, shards, size=shape)).astype(np.int32)
    return {"key": rng.integers(0, 1000, size=shape).astype(np.int32),
            "x": rng.integers(0, 9, size=shape).astype(np.int32),
            "ts": rng.integers(0, 50, size=shape).astype(np.int32),
            "sid": rng.integers(0, 3, size=shape).astype(np.int32),
            "valid": rng.random(shape) < 0.8, "dest": dest}


def plain(tree):
    """Dataclasses -> dicts, arrays -> numpy (the ``convert.to_plain``
    form, without importing the port)."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: plain(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(plain(v) for v in tree)
    return np.asarray(tree)


def dir_bytes(d):
    """Every file under ``d`` by relative path -> its bytes."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def run_reference(out_path, group, *args, timeout=600):
    """Start this module as the reference subprocess; returns its pickled
    results."""
    import subprocess
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(out_path), group, *map(str, args)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(out_path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------
# the JAX side (subprocess only)
# ---------------------------------------------------------------------

def _jax_env():
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.core.event import EventBatch
    from repro.core.operators import AssociativeUpdater, Mapper
    from tests.conftest import (CountingUpdater, LastValueUpdater,
                                PassThroughMapper)

    class SumCounter(CountingUpdater):
        sum_mergeable = True

    class MaxCounter(CountingUpdater):
        name = "U3"
        monoid = "max"

        def lift(self, batch):
            return {"count": batch.value["x"],
                    "sum": batch.value["x"].astype(jnp.float32)}

        def combine(self, a, b):
            return jax.tree.map(jnp.maximum, a, b)

        merge = combine

    class Counter1(AssociativeUpdater):
        """A count on S1 (the reference tests' ``Counter``)."""
        name = "U1"
        subscribes = ("S1",)
        in_value_spec = {"x": ((), jnp.int32)}
        out_streams = {}
        table_capacity = 512

        def slate_spec(self):
            return {"count": ((), jnp.int32)}

        def lift(self, b):
            return {"count": jnp.ones_like(b.key)}

        def combine(self, a, b):
            return {"count": a["count"] + b["count"]}

        def merge(self, s, d):
            return {"count": s["count"] + d["count"]}

    VF = {"x": ((), jnp.float32)}

    class ECounter(AssociativeUpdater):
        """``tests/test_elasticity.py``'s ``Counter``: count and f32 sum."""
        name = "U1"
        subscribes = ("S1",)
        in_value_spec = VF
        out_streams = {}
        table_capacity = 1024
        sum_mergeable = True

        def slate_spec(self):
            return {"count": ((), jnp.int32), "sum": ((), jnp.float32)}

        def lift(self, b):
            return {"count": jnp.ones_like(b.key), "sum": b.value["x"]}

        def combine(self, a, b):
            return {"count": a["count"] + b["count"],
                    "sum": a["sum"] + b["sum"]}

        merge = combine

    class ECounter2(ECounter):
        name = "U2"

    class EFwd(Mapper):
        name = "M1"
        subscribes = ("S1",)
        in_value_spec = VF
        out_streams = {"S2": VF}

        def map_batch(self, b):
            return {"S2": EventBatch(sid=b.sid, ts=b.ts + 1, key=b.key,
                                     value=b.value, valid=b.valid)}

    class ECounterS2(ECounter):
        subscribes = ("S2",)

    def elastic_ops(kind):
        return {"U1": lambda: [ECounter()],
                "U1U2": lambda: [ECounter(), ECounter2()],
                "fwd": lambda: [EFwd(), ECounterS2()]}[kind]()

    def gbf(keys, xs, t, n, valid=None):
        k = keys.reshape(n, -1)
        v = np.ones(k.shape, bool) if valid is None else valid.reshape(n, -1)
        return EventBatch(sid=jnp.zeros(k.shape, jnp.int32),
                          ts=jnp.full(k.shape, t, jnp.int32),
                          key=jnp.asarray(k),
                          value={"x": jnp.asarray(xs.reshape(n, -1))},
                          valid=jnp.asarray(v))

    def mesh(n):
        return Mesh(np.array(jax.devices()[:n]), ("data",))

    def batch(d):
        return EventBatch(sid=jnp.zeros(d["key"].shape, jnp.int32),
                          ts=jnp.asarray(d["ts"]), key=jnp.asarray(d["key"]),
                          value={"x": jnp.asarray(d["x"])},
                          valid=jnp.asarray(d["valid"]))

    return dict(jax=jax, jnp=jnp, mesh=mesh, batch=batch,
                EventBatch=EventBatch, PassThroughMapper=PassThroughMapper,
                CountingUpdater=CountingUpdater,
                LastValueUpdater=LastValueUpdater, SumCounter=SumCounter,
                MaxCounter=MaxCounter, Counter1=Counter1,
                elastic_ops=elastic_ops, gbf=gbf)


def _reads(eng, state, updater, keys=READ_KEYS, loop_keys=LOOP_KEYS):
    """Per-key ``read_slate`` over ``loop_keys`` and one batched
    ``read_slates`` (``impl="jnp"``) over ``keys``."""
    return {"looped": [plain(eng.read_slate(state, updater, int(k)))
                       for k in loop_keys],
            "batched": [plain(r) for r in eng.read_slates(
                state, updater, keys, impl="jnp")]}


def _count_scenario(E, serve=False):
    """Counting through a mapper, the generic and the sequential path
    (``COUNT``), with reads; with ``serve``, before the drain,
    ``StateHandle.serve``'s bodies of ``serve_paths()``."""
    jax, batch = E["jax"], E["batch"]
    from repro.core.distributed import DistConfig, DistributedEngine
    from repro.core.engine import StateHandle
    from repro.core.workflow import Workflow
    eng = DistributedEngine(
        Workflow([E["PassThroughMapper"](), E["CountingUpdater"](),
                  E["LastValueUpdater"]()], external_streams=("S1",)),
        E["mesh"](8), DistConfig(batch_size=64, queue_capacity=512))
    st = eng.init_state()
    outs = []
    for d in feeds(**COUNT):
        st, o = eng.step(st, {"S1": batch(d)})
        outs.append(plain(jax.device_get(o)))
    served = None
    if serve:
        srv = StateHandle(eng, st).serve()
        try:
            served = {p: http_get(srv.port, p) for p in serve_paths()}
        finally:
            srv.close()
    st, drained = eng.drain(st)
    return dict(state=plain(jax.device_get(st)), stats=eng.stats(st),
                outputs=outs, drained=drained, reads=_reads(eng, st, "U1"),
                served=served)


def group_ranks():
    """The fixed-membership scenario alone, for the port's rank tests,
    with its served bodies."""
    return {"count": _count_scenario(_jax_env(), serve=True)}


def group_engine():
    E = _jax_env()
    jax, jnp, batch = E["jax"], E["jnp"], E["batch"]
    from repro.core.distributed import DistConfig, DistributedEngine, \
        exchange
    from repro.core.workflow import Workflow
    from repro.telemetry import TelemetryConfig
    res = {}

    def wf(*ops):
        return Workflow(list(ops), external_streams=("S1",))

    # counting through a mapper, the generic and the sequential path
    res["count"] = _count_scenario(E)

    # run_chunk on stacked [T, S, B] sources, on the packed-table oracle
    # (the JAX package's "off" and "jnp" backends give the same state
    # bitwise on these integer feeds; the port holds all of its own
    # backends against this one)
    stack = lambda ds: jax.tree.map(lambda *xs: jnp.stack(xs),
                                    *[batch(d) for d in ds])
    eng = DistributedEngine(
        wf(E["PassThroughMapper"](), E["SumCounter"](), E["MaxCounter"]()),
        E["mesh"](8), DistConfig(batch_size=64, queue_capacity=512,
                                 fused="ref"))
    st = eng.init_state()
    fs = feeds(**CHUNK)
    st, _, info = eng.run_chunk(st, {"S1": stack(fs)})
    empty = [dict(d, valid=np.zeros_like(d["valid"]), ts=d["ts"] + 900)
             for d in fs[:4]]
    st, _, _ = eng.run_chunk(st, {"S1": stack(empty)})
    res["chunk"] = dict(state=plain(jax.device_get(st)), stats=eng.stats(st),
                        hits_shape=tuple(info["throttle_hits"].shape))

    # the bare exchange under shard_map
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    ex = exchange_inputs(**EXCHANGE)
    b = E["EventBatch"](sid=jnp.asarray(ex["sid"]), ts=jnp.asarray(ex["ts"]),
                        key=jnp.asarray(ex["key"]),
                        value={"x": jnp.asarray(ex["x"])},
                        valid=jnp.asarray(ex["valid"]))

    def local(bb, dd):
        bb = jax.tree.map(lambda x: x[0], bb)
        recv, dropped = exchange(bb, dd[0], ("data",), EXCHANGE["cap"])
        return jax.tree.map(lambda x: x[None], recv), dropped[None]

    fn = shard_map(local, mesh=E["mesh"](8), in_specs=(P("data"), P("data")),
                   out_specs=P("data"), check_rep=False)
    recv, dropped = jax.jit(fn)(b, jnp.asarray(ex["dest"]))
    res["exchange"] = dict(recv=plain(jax.device_get(recv)),
                           dropped=np.asarray(dropped))

    # buckets that overflow at a small slack
    eng = DistributedEngine(
        wf(E["PassThroughMapper"](), E["CountingUpdater"]()), E["mesh"](8),
        DistConfig(batch_size=64, queue_capacity=512, exchange_slack=0.5))
    st = eng.init_state()
    for d in feeds(**SLACK):
        st, _ = eng.step(st, {"S1": batch(d)})
    st, _ = eng.drain(st)
    res["slack"] = dict(state=plain(jax.device_get(st)),
                        stats=eng.stats(st), cap=eng.cap_per_dest)

    # fail-over: shard 3 dies after 8 ticks
    eng = DistributedEngine(
        wf(E["PassThroughMapper"](), E["CountingUpdater"]()), E["mesh"](8),
        DistConfig(batch_size=64, queue_capacity=512))
    st = eng.init_state()
    fs = feeds(**FAIL)
    for d in fs[:8]:
        st, _ = eng.step(st, {"S1": batch(d)})
    st, _ = eng.drain(st)
    before = eng.stats(st)
    st = eng.fail_shard(st, 3)
    failed = plain(jax.device_get(st))
    for d in fs[8:]:
        st, _ = eng.step(st, {"S1": batch(d)})
    st, _ = eng.drain(st)
    res["failover"] = dict(before=before, failed=failed,
                           state=plain(jax.device_get(st)),
                           stats=eng.stats(st),
                           reads=_reads(eng, st, "U1"))

    # two-choice: one hot key spills to its secondary shard
    eng = DistributedEngine(wf(E["Counter1"]()), E["mesh"](8), DistConfig(
        batch_size=256, queue_capacity=2048, exchange_slack=8.0,
        two_choice_threshold=4))
    st = eng.init_state()
    for d in feeds(**TWO):
        st, _ = eng.step(st, {"S1": batch(d)})
    st, _ = eng.drain(st, 6)
    res["two_choice"] = dict(state=plain(jax.device_get(st)),
                             stats=eng.stats(st),
                             reads=_reads(eng, st, "U1"))

    # the run driver with telemetry (window 4)
    eng = DistributedEngine(
        wf(E["PassThroughMapper"](), E["CountingUpdater"]()), E["mesh"](8),
        DistConfig(batch_size=64, queue_capacity=512,
                   telemetry=TelemetryConfig(width=256, window=4)))
    fs = feeds(**RUN)
    fed = []

    def src(t, mx):
        fed.append((t, mx))
        return {"S1": batch(fs[t])}

    st, outs = eng.run(eng.init_state(), src, len(fs))
    rep = eng.telemetry.last
    res["run"] = dict(state=plain(jax.device_get(st)), stats=eng.stats(st),
                      fed=fed, n_outputs=len(outs),
                      cursor=eng.tick_cursor,
                      report=dict(events=rep.events,
                                  heavy=rep.heavy_hitters,
                                  queue_depth=rep.queue_depth,
                                  dropped=rep.dropped_delta,
                                  occupancy=rep.occupancy, tick=rep.tick,
                                  p99=rep.event_latency_p99))

    # reads: plain routing, two-choice partials, a hot-key entry
    from repro.core.operators import AssociativeUpdater

    class RCounter(AssociativeUpdater):
        name = "U1"
        subscribes = ("S1",)
        in_value_spec = {"x": ((), jnp.int32)}
        out_streams = {}
        table_capacity = 1024
        sum_mergeable = True

        def slate_spec(self):
            return {"count": ((), jnp.int32), "sum": ((), jnp.float32)}

        def lift(self, b):
            return {"count": jnp.ones_like(b.key),
                    "sum": b.value["x"].astype(jnp.float32)}

        def combine(self, a, b):
            return {"count": a["count"] + b["count"],
                    "sum": a["sum"] + b["sum"]}

        merge = combine

    class Vec(RCounter):
        name = "UV"

        def slate_spec(self):
            return {"v": ((8,), jnp.float32)}

        def lift(self, b):
            return {"v": jnp.broadcast_to(
                b.value["x"].astype(jnp.float32)[:, None],
                (b.key.shape[0], 8))}

        def combine(self, a, b):
            return {"v": a["v"] + b["v"]}

        merge = combine

    def drive(cfg):
        eng = DistributedEngine(wf(RCounter(), Vec()), E["mesh"](4), cfg)
        st = eng.init_state()
        for d in feeds(**READS):
            st, _ = eng.step(st, {"S1": batch(d)})
        st, _ = eng.drain(st)
        return eng, st

    eng, st = drive(DistConfig(batch_size=32, queue_capacity=256,
                               fused="off"))
    res["reads_plain"] = {u: _reads(eng, st, u) for u in ("U1", "UV")}
    res["reads_plain"]["state"] = plain(jax.device_get(st))
    eng._hot_keys[0] = np.int32(7)
    eng._hot_valid[0] = True
    eng._read_fns.clear()     # the batched read now merges a secondary
    res["reads_hot"] = _reads(eng, st, "U1")
    eng2, st2 = drive(DistConfig(batch_size=32, queue_capacity=256,
                                 fused="off", two_choice_threshold=4))
    res["reads_two"] = {u: _reads(eng2, st2, u) for u in ("U1", "UV")}
    res["reads_two"]["state"] = plain(jax.device_get(st2))
    res["reads_two"]["stats"] = eng2.stats(st2)
    return res


def _split_counter(jnp, AssociativeUpdater, subscribes):
    class Counter(AssociativeUpdater):
        """The count + f32 sum of ``tests/test_read_tier.py``."""
        name = "U1"
        in_value_spec = {"x": ((), jnp.int32)}
        out_streams = {}
        table_capacity = 1024
        sum_mergeable = True

        def slate_spec(self):
            return {"count": ((), jnp.int32), "sum": ((), jnp.float32)}

        def lift(self, b):
            return {"count": jnp.ones_like(b.key),
                    "sum": b.value["x"].astype(jnp.float32)}

        def combine(self, a, b):
            return {"count": a["count"] + b["count"],
                    "sum": a["sum"] + b["sum"]}

        merge = combine

    Counter.subscribes = subscribes
    return Counter()


def group_hotspot():
    E = _jax_env()
    jax, jnp, batch = E["jax"], E["jnp"], E["batch"]
    from repro.core.distributed import DistConfig, DistributedEngine
    from repro.core.hotspot import (KeySplitMapper, read_split_slate,
                                    subkeys_of)
    from repro.core.operators import AssociativeUpdater
    from repro.core.workflow import Workflow
    from repro.telemetry import TelemetryConfig
    res = {}

    # split_keys on the engine: the hot key's events alternate between
    # its primary and secondary shard from the next tick on
    eng = DistributedEngine(
        Workflow([_split_counter(jnp, AssociativeUpdater, ("S1",))],
                 external_streams=("S1",)),
        E["mesh"](4), DistConfig(batch_size=64, queue_capacity=2048,
                                 exchange_slack=16.0, hot_key_capacity=8,
                                 telemetry=TelemetryConfig(width=256)))
    st = eng.init_state()
    fs = feeds(**SPLIT)
    for d in fs[:3]:
        st, _ = eng.step(st, {"S1": batch(d)})
    st, _ = eng.split_keys(st, [SPLIT["hot"]])
    split_set = eng.split_key_set()
    for d in fs[3:]:
        st, _ = eng.step(st, {"S1": batch(d)})
    for _ in range(4):
        st = eng._step_empty(st)
    res["split"] = dict(state=plain(jax.device_get(st)),
                        stats=eng.stats(st), split_set=split_set,
                        reads=_reads(eng, st, "U1"))

    # KeySplitMapper in front of a counter, split keys read back
    ways = 4
    eng = DistributedEngine(
        Workflow([KeySplitMapper("S1", "S2", {"x": ((), jnp.int32)},
                                 ways=ways),
                  _split_counter(jnp, AssociativeUpdater, ("S2",))],
                 external_streams=("S1",)),
        E["mesh"](4), DistConfig(batch_size=32, queue_capacity=512,
                                 fused="off"))
    st = eng.init_state()
    for d in feeds(**SPLIT_READS):
        st, _ = eng.step(st, {"S1": batch(d)})
    st, _ = eng.drain(st)
    hot = SPLIT_READS["hot"]
    subs = np.asarray(subkeys_of(hot, ways), np.int32)
    res["split_reads"] = dict(
        state=plain(jax.device_get(st)), stats=eng.stats(st),
        subs=subs, reads=_reads(eng, st, "U1", subs, subs),
        merged=plain(read_split_slate(eng, st, "U1", hot, ways)),
        merged_cold=[plain(read_split_slate(eng, st, "U1", k, ways))
                     for k in range(12)])
    return res


def _slates(eng, st):
    """Keys 0-63 of ``U1`` through one batched read."""
    return dict(enumerate(plain(r) for r in eng.read_slates(
        st, "U1", np.arange(64, dtype=np.int32), impl="jnp")))


def group_durable(base, port_crash):
    """Durable runs in directories under ``base``: ``full`` (12 ticks,
    a flush every 4 engine ticks) and ``crash`` (9 ticks: the frontier
    covers 7, the log holds 2 more; left for the port to recover); the
    port's crash directory ``port_crash``, recovered here; and the
    launcher at ``--shards 8``."""
    E = _jax_env()
    jax, batch = E["jax"], E["batch"]
    from repro.core.distributed import DistConfig, DistributedEngine
    from repro.core.durability import DurabilityConfig
    from repro.core.workflow import Workflow
    from repro.slates.flush import FlushConfig, FlushPolicy
    res = {}

    def build(d):
        cfg = DistConfig(batch_size=64, queue_capacity=256,
                         durability=DurabilityConfig(
                             dir=d, flush=FlushConfig(
                                 policy=FlushPolicy.EVERY_K,
                                 every_k=DURABLE_EVERY)))
        wf = Workflow([E["PassThroughMapper"](), E["CountingUpdater"]()],
                      external_streams=("S1",))
        return DistributedEngine(wf, E["mesh"](8), cfg)

    src = lambda t: {"S1": batch(durable_feed(t))}

    def done(eng, st, **more):
        out = dict(state=plain(jax.device_get(st)), stats=eng.stats(st),
                   frontier=(eng.dur.frontier.tick,
                             list(eng.dur.frontier.wal_offset),
                             eng.dur.frontier.meta),
                   cursor=eng.tick_cursor, **more)
        eng.close()
        return out

    eng = build(os.path.join(base, "full"))
    st, nxt = eng.run_durable(eng.init_state(), src, DURABLE_TICKS)
    res["full"] = done(eng, st, next=nxt, slates=_slates(eng, st))
    eng = build(os.path.join(base, "crash"))
    st, _ = eng.run_durable(eng.init_state(), src, DURABLE_CRASH)
    res["crash_frontier"] = eng.dur.frontier.tick
    eng.close()                               # crash: the state is lost
    res["crash_files"] = dir_bytes(os.path.join(base, "crash"))
    eng = build(port_crash)
    st = eng.recover()
    tick = int(np.asarray(jax.device_get(st["tick"])).max())
    recovered = plain(jax.device_get(st))
    st, _ = eng.run_durable(st, src, DURABLE_TICKS - DURABLE_CRASH,
                            start_tick=DURABLE_CRASH)
    res["recover_port"] = done(eng, st, tick=tick, recovered=recovered,
                               slates=_slates(eng, st))

    # the launcher at 8 shards: uninterrupted, crashed at 40, recovered
    import contextlib
    import io
    from repro.launch import stream
    res["launcher"] = {}
    for run, more in (("full", []), ("crash", ["--crash-at", "40"]),
                      ("recover", ["--recover"])):
        d = os.path.join(base, "launch_" + ("full" if run == "full"
                                            else "crash"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stream.main(["--dir", d, "--shards", "8", "--batch", "64",
                         *more])
        res["launcher"][run] = buf.getvalue()
    return res



def _elastic_engine(E, spec, **more):
    from jax.sharding import Mesh
    from repro.core.distributed import DistConfig, DistributedEngine
    from repro.core.workflow import Workflow
    from repro.telemetry import TelemetryConfig
    jax = E["jax"]
    shards = spec["shards"]
    axes = spec.get("axes", ("data",))
    n = int(np.prod(shards))
    m = Mesh(np.array(jax.devices()[:n]).reshape(shards), axes)
    cfg = dict(spec["cfg"], **more)
    if "telemetry" in spec:
        cfg["telemetry"] = TelemetryConfig(**spec["telemetry"])
    return DistributedEngine(
        Workflow(E["elastic_ops"](spec["ops"]), external_streams=("S1",)),
        m, DistConfig(axis_names=axes, **cfg))


def _jax_play(E, spec):
    jax = E["jax"]
    return play(spec, _elastic_engine(E, spec), E["gbf"],
                    lambda st: plain(jax.device_get(st)),
                    lambda e, st, ks: [plain(r) for r in e.read_slates(
                        st, "U1", ks, impl="jnp")])


def group_elastic(*names):
    """The ``ELASTIC`` scenarios named (each test file plays its own)."""
    E = _jax_env()
    return {name: _jax_play(E, ELASTIC[name]) for name in names}


# the durable scenarios (tests/test_elasticity.py::test_autoscale_policy_
# through_run_and_durability and ::test_compaction_durable_recovery)
AUTOSCALE_DURABLE = dict(shards=4, ticks=8, scale_at={4: 8},
                         rebalance_every=3, every_k=4)
COMPACT_DURABLE = dict(shards=8, run=6, leave=list(range(2, 8)), more=2,
                       every_k=2)


def autoscale_feed(t, n=64):
    """Source tick t of the durable autoscale run: its own seed, so a
    replay regenerates it."""
    r = np.random.default_rng(t)
    return (r.integers(0, 32, n).astype(np.int32),
            r.integers(0, 99, n).astype(np.float32))


def compact_feed(t):
    r = np.random.default_rng(100 + t)
    return r.integers(0, 64, 64).astype(np.int32), np.ones(64, np.float32)


def durable_elastic_run(eng, batch, host, reports):
    """The autoscale run of either package (``reports`` the policy's
    ``on_change`` list): 8 source ticks, 4 -> 8 shards at tick 4, a
    rebalance every 3, a flush every 4."""
    st = eng.init_state()
    fed = []

    def src(t, _mx):
        fed.append(t)
        return {"S1": batch(*autoscale_feed(t), t, eng.n_shards)}

    st, _ = eng.run(st, src, AUTOSCALE_DURABLE["ticks"])
    st, drained = eng.drain(st)
    return dict(state=host(st), stats=eng.stats(st), fed=fed,
                drained=drained, reports=[report_fields(r) for r in reports],
                n_shards=eng.n_shards, cursor=eng.tick_cursor,
                frontier=(eng.dur.frontier.tick,
                          list(eng.dur.frontier.wal_offset),
                          eng.dur.frontier.meta),
                wal_ticks=[[tk for tk, _ in w.replay(from_offset=0)]
                           for w in eng.dur.wals]), st


def compact_durable_run(eng, batch, host):
    """The compaction run of either package: 6 ticks on 8 shards, leave
    6 of them (a compaction to 2), drain, 2 more ticks, drain."""
    c = COMPACT_DURABLE
    st, _ = eng.run(eng.init_state(), lambda t, _mx: {"S1": batch(
        *compact_feed(t), t, eng.n_shards)}, c["run"])
    st, rep = eng.remove_shards(st, c["leave"])
    st, _ = eng.drain(st)
    mid = host(st)
    st, _ = eng.run(st, lambda t, _mx: {"S1": batch(
        *compact_feed(t), t, eng.n_shards)}, c["more"],
        start_tick=c["run"])
    st, _ = eng.drain(st)
    return dict(report=report_fields(rep), mid=mid, state=host(st),
                stats=eng.stats(st), n_wals=len(eng.dur.wals),
                frontier=(eng.dur.frontier.tick,
                          list(eng.dur.frontier.wal_offset),
                          eng.dur.frontier.meta)), st


def group_elastic_durable(base, port_auto):
    """In directories under ``base``: the JAX autoscale run (copied for
    the port to recover), its own recovery on 8 and on 4 shards, the
    port's autoscale run ``port_auto`` recovered on 8; the compaction run
    (copied too) and its recovery on 2 shards; the launcher's
    ``--scale-at`` run."""
    import shutil
    E = _jax_env()
    jax = E["jax"]
    from jax.sharding import Mesh
    from repro.core.distributed import (AutoscalePolicy, DistConfig,
                                        DistributedEngine)
    from repro.core.durability import DurabilityConfig
    from repro.core.workflow import Workflow
    from repro.slates.flush import FlushConfig, FlushPolicy
    host = lambda st: plain(jax.device_get(st))
    res = {}

    def build(d, n, every_k, ops="fwd", policy=None):
        cfg = DistConfig(batch_size=64 if ops == "fwd" else 32,
                         queue_capacity=512 if ops == "fwd" else 256,
                         fused="off" if ops == "U1" else "auto",
                         durability=DurabilityConfig(
                             dir=d, flush=FlushConfig(
                                 policy=FlushPolicy.EVERY_K,
                                 every_k=every_k)),
                         autoscale=policy)
        return DistributedEngine(
            Workflow(E["elastic_ops"](ops), external_streams=("S1",)),
            Mesh(np.array(jax.devices()[:n]), ("data",)), cfg)

    def recovered(d, n, every_k, ops="fwd"):
        eng = build(d, n, every_k, ops)
        st = eng.recover()
        st, _ = eng.drain(st)
        out = dict(state=host(st), stats=eng.stats(st),
                   slates=[plain(r) for r in eng.read_slates(
                       st, "U1", np.arange(64, dtype=np.int32),
                       impl="jnp")])
        eng.close()
        return out

    a = AUTOSCALE_DURABLE
    d = os.path.join(base, "auto")
    reports = []
    eng = build(d, a["shards"], a["every_k"], policy=AutoscalePolicy(
        scale_at=dict(a["scale_at"]), rebalance_every=a["rebalance_every"],
        on_change=reports.append))
    res["auto"], st = durable_elastic_run(eng, E["gbf"], host, reports)
    res["auto"]["slates"] = [plain(r) for r in eng.read_slates(
        st, "U1", np.arange(64, dtype=np.int32), impl="jnp")]
    eng.close()
    res["auto_files"] = dir_bytes(d)
    shutil.copytree(d, os.path.join(base, "auto_for_port"))
    for n in (8, 4):
        res[f"auto_recover_{n}"] = recovered(d, n, a["every_k"])
    # the port's files equal these byte for byte (the port's test checks
    # it), so one recovery of them here stands for both shard counts and
    # for the compaction run's files
    res["port_auto_recover_8"] = recovered(port_auto, 8, a["every_k"])

    c = COMPACT_DURABLE
    d = os.path.join(base, "compact")
    eng = build(d, c["shards"], c["every_k"], ops="U1")
    res["compact"], st = compact_durable_run(eng, E["gbf"], host)
    eng.close()
    res["compact_files"] = dir_bytes(d)
    shutil.copytree(d, os.path.join(base, "compact_for_port"))
    res["compact_recover"] = recovered(d, 2, c["every_k"], ops="U1")

    import contextlib
    import io
    from repro.launch import stream
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stream.main(["--dir", os.path.join(base, "launch_scale"),
                     *LAUNCH_SCALE])
    res["launcher"] = buf.getvalue()
    return res


# a leave to 2 of 4 shards and rebalances: the device tier (the
# autoscale run above covers the grow)
LAUNCH_SCALE = ["--ticks", "12", "--batch", "64", "--shards", "4",
                "--scale-at", "6:2", "--rebalance-every", "4"]

# tests/test_telemetry.py::test_closed_loop_square_wave_2to4_fast
CLOSED_LOOP = dict(G=64, low=2, high=4, ticks=60)


def closed_loop_feed(t, G=CLOSED_LOOP["G"]):
    rng = np.random.default_rng(t)
    keys = rng.integers(0, 48, G).astype(np.int32)
    xs = rng.integers(0, 9, G).astype(np.float32)
    hi = (t // 15) % 2 == 0          # square wave, period 30
    n = G if hi else G // 10
    return keys, xs, np.arange(G) < n


def closed_loop_run(eng, batch, host, reads):
    """The square wave through either package's ``run``: the active
    count each tick reads, the state and reads after a drain."""
    st = eng.init_state()
    trace = []

    def src(t, _mx):
        trace.append(len(eng.active_shards))
        keys, xs, valid = closed_loop_feed(t)
        return {"S1": batch(keys, xs, t, eng.n_shards, valid)}

    st, _ = eng.run(st, src, CLOSED_LOOP["ticks"])
    st, _ = eng.drain(st)
    return dict(trace=trace, state=host(st), stats=eng.stats(st),
                reads=reads(eng, st, np.arange(48, dtype=np.int32)),
                n_shards=eng.n_shards, active=list(eng.active_shards))


def group_closed_loop(log_path):
    E = _jax_env()
    jax = E["jax"]
    from jax.sharding import Mesh
    from repro.core.distributed import DistConfig, DistributedEngine
    from repro.core.workflow import Workflow
    from repro.telemetry import LoadAutoscaler, TelemetryConfig
    c = CLOSED_LOOP
    reports = []
    ctl = LoadAutoscaler(high=0.75, low=0.25, window=3, dwell=2,
                         cooldown=1, min_shards=c["low"],
                         max_shards=c["high"], on_change=reports.append)
    eng = DistributedEngine(
        Workflow(E["elastic_ops"]("U1"), external_streams=("S1",)),
        Mesh(np.array(jax.devices()[:c["low"]]), ("data",)),
        DistConfig(batch_size=c["G"] // c["low"], queue_capacity=4 * c["G"],
                   fused="off", exchange_slack=8.0,
                   telemetry=TelemetryConfig(width=256, alpha=1.0,
                                             control_log=log_path),
                   autoscale=ctl))
    out = closed_loop_run(eng, E["gbf"], lambda st: plain(jax.device_get(st)),
                          lambda e, st, ks: [plain(r) for r in e.read_slates(
                              st, "U1", ks, impl="jnp")])
    eng.close()
    out["reports"] = [report_fields(r) for r in reports]
    with open(log_path) as f:
        out["control_log"] = f.read()
    return out


def main(argv):
    out, group, *args = argv
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    res = {"engine": group_engine, "ranks": group_ranks,
           "hotspot": group_hotspot,
           "durable": group_durable, "elastic": group_elastic,
           "elastic_durable": group_elastic_durable,
           "closed_loop": group_closed_loop}[group](*args)
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
