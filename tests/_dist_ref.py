"""The JAX ``DistributedEngine`` side of the port's multi-shard parity
tests, run in ONE subprocess per test file (an 8-device host platform
needs ``XLA_FLAGS`` before JAX starts, so never in the pytest process).

    python tests/_dist_ref.py OUT.pkl GROUP [ARG ...]

runs every reference scenario of GROUP (``engine``, ``hotspot`` or
``durable``) and pickles their results — states in the plain numpy form
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
    from repro.core.operators import AssociativeUpdater
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
                MaxCounter=MaxCounter, Counter1=Counter1)


def _reads(eng, state, updater, keys=READ_KEYS, loop_keys=LOOP_KEYS):
    """Per-key ``read_slate`` over ``loop_keys`` and one batched
    ``read_slates`` (``impl="jnp"``) over ``keys``."""
    return {"looped": [plain(eng.read_slate(state, updater, int(k)))
                       for k in loop_keys],
            "batched": [plain(r) for r in eng.read_slates(
                state, updater, keys, impl="jnp")]}


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
    eng = DistributedEngine(
        wf(E["PassThroughMapper"](), E["CountingUpdater"](),
           E["LastValueUpdater"]()),
        E["mesh"](8), DistConfig(batch_size=64, queue_capacity=512))
    st = eng.init_state()
    outs = []
    for d in feeds(**COUNT):
        st, o = eng.step(st, {"S1": batch(d)})
        outs.append(plain(jax.device_get(o)))
    st, drained = eng.drain(st)
    res["count"] = dict(state=plain(jax.device_get(st)),
                        stats=eng.stats(st), outputs=outs, drained=drained,
                        reads=_reads(eng, st, "U1"))

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


def main(argv):
    out, group, *args = argv
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    res = {"engine": group_engine, "hotspot": group_hotspot,
           "durable": group_durable}[group](*args)
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
