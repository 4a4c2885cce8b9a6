"""Port parity: the single-shard engine, against the JAX ``Engine`` on the
``conftest.py`` workflows (rewritten in torch here) fed identical numpy
sources.  Engine state is compared whole and bitwise through
``repro_torch.convert`` — queues, tables, tick and counters — together
with ``read_slate``, ``read_slates`` and ``stats``.  Values are
integers, so f32 sums are exact (the counter contract)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.engine import Engine as JEngine
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import stack_sources as j_stack
from repro.core.event import EventBatch as JBatch
from repro.core.queues import OverflowPolicy as JPolicy
from repro.core.workflow import Workflow as JWorkflow
from repro_torch import convert
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import StateHandle
from repro_torch.core.engine import stack_sources as t_stack
from repro_torch.core.event import EventBatch as TBatch
from repro_torch.core.operators import (AssociativeUpdater, Mapper,
                                        SequentialUpdater)
from repro_torch.core.queues import OverflowPolicy as TPolicy
from repro_torch.core.workflow import Workflow as TWorkflow
from tests.conftest import (CountingUpdater, LastValueUpdater,
                            PassThroughMapper)

VSPEC = {"x": ((), torch.int32)}


# ---- the conftest workflows, in torch ----
class TPassThroughMapper(Mapper):
    name = "M1"
    subscribes = ("S1",)
    in_value_spec = VSPEC
    out_streams = {"S2": VSPEC}

    def map_batch(self, batch):
        return {"S2": TBatch(sid=batch.sid, ts=batch.ts + 1, key=batch.key,
                             value=batch.value, valid=batch.valid)}


class TCountingUpdater(AssociativeUpdater):
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

    def merge(self, slate, delta):
        return {"count": slate["count"] + delta["count"],
                "sum": slate["sum"] + delta["sum"]}


class TLastValueUpdater(SequentialUpdater):
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
        emit = {"S3": {"key": ev["key"], "value": {"x": new["n"]},
                       "emit": True}}
        return new, emit


class JSumCounter(CountingUpdater):
    sum_mergeable = True


class TSumCounter(TCountingUpdater):
    sum_mergeable = True


class JMaxCounter(CountingUpdater):
    """x is non-negative in these feeds, so max is the declared monoid."""
    name = "U3"
    monoid = "max"

    def lift(self, batch):
        return {"count": batch.value["x"],
                "sum": batch.value["x"].astype(jnp.float32)}

    def combine(self, a, b):
        return jax.tree.map(jnp.maximum, a, b)

    merge = combine


class TMaxCounter(TCountingUpdater):
    name = "U3"
    monoid = "max"

    def lift(self, batch):
        return {"count": batch.value["x"].clone(),
                "sum": batch.value["x"].to(torch.float32)}

    def combine(self, a, b):
        return {k: torch.maximum(a[k], b[k]) for k in a}

    merge = combine


# ---- feeding both engines ----
def _feed(rng, n, key_hi=24, t=0, p_valid=0.85):
    return {"key": rng.integers(0, key_hi, size=n).astype(np.int32),
            "x": rng.integers(0, 9, size=n).astype(np.int32),
            "ts": np.full(n, t, np.int32),
            "valid": rng.random(n) < p_valid}


def _jb(d):
    return JBatch.of(jnp.asarray(d["key"]), {"x": jnp.asarray(d["x"])},
                     ts=jnp.asarray(d["ts"]), valid=jnp.asarray(d["valid"]))


def _tb(d, key_dtype=torch.int32):
    return TBatch.of(torch.from_numpy(d["key"]).to(key_dtype),
                     {"x": torch.from_numpy(d["x"])},
                     ts=torch.from_numpy(d["ts"]),
                     valid=torch.from_numpy(d["valid"]))


def _eq_tree(a, b, path="state"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _eq_tree(a[k], b[k], f"{path}.{k}")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _eq_state(jstate, tstate):
    _eq_tree(convert.to_plain(jax.device_get(jstate)),
             convert.state_to_numpy(tstate))


def _eq_reads(jeng, jst, teng, tst, updater, keys):
    for k in keys[:6]:      # point reads are slow on the JAX side
        a, b = jeng.read_slate(jst, updater, int(k)), \
            teng.read_slate(tst, updater, int(k))
        assert (a is None) == (b is None), k
        if a is not None:
            _eq_tree(a, {f: v.numpy() for f, v in b.items()})
    ra = jeng.read_slates(jst, updater, keys)
    rb = teng.read_slates(tst, updater, keys)
    assert [r is None for r in ra] == [r is None for r in rb]
    for a, b in zip(ra, rb):
        if a is not None:
            _eq_tree(a, {f: v.numpy() for f, v in b.items()})
    assert jeng.stats(jst) == teng.stats(tst)


def _engines(jops, tops, external=("S1",), **cfg):
    j = JEngine(JWorkflow(jops, external_streams=external), JConfig(**cfg))
    t = TEngine(TWorkflow(tops, external_streams=external), TConfig(**cfg),
                device="cpu")
    return j, t


def _run_steps(jeng, teng, feeds, jst=None, tst=None):
    jst = jeng.init_state() if jst is None else jst
    tst = teng.init_state() if tst is None else tst
    for d in feeds:
        jst, jout = jeng.step(jst, {"S1": _jb(d)})
        tst, tout = teng.step(tst, {"S1": _tb(d)})
        assert set(jout) == set(tout)
        for s in jout:
            _eq_tree(convert.to_plain(jout[s]), convert.to_plain(tout[s]))
    return jst, tst


# ---- tests ----
@pytest.mark.parametrize("fused", ["off", "jnp", "ref"])
def test_counting_parity(fused):
    """Generic and fused paths, with a sum_mergeable counter and a max
    monoid beside the conftest counter: state, reads and stats equal."""
    rng = np.random.default_rng(0)
    jeng = JEngine(JWorkflow([PassThroughMapper(), CountingUpdater(),
                              JMaxCounter()], external_streams=("S1",)),
                   JConfig(batch_size=16, queue_capacity=64, fused=fused))
    teng = TEngine(TWorkflow([TPassThroughMapper(), TCountingUpdater(),
                              TMaxCounter()], external_streams=("S1",)),
                   TConfig(batch_size=16, queue_capacity=64, fused=fused),
                   device="cpu")
    feeds = [_feed(rng, 12, t=t) for t in range(8)]
    feeds += [_feed(rng, 12, t=t, p_valid=0.0) for t in range(8, 10)]
    jst, tst = _run_steps(jeng, teng, feeds)
    _eq_state(jst, tst)
    keys = list(range(-2, 26))
    _eq_reads(jeng, jst, teng, tst, "U1", keys)
    _eq_reads(jeng, jst, teng, tst, "U3", keys)


@pytest.mark.parametrize("fused,port_fused", [("off", "off"),
                                              ("ref", "auto")])
def test_sum_mergeable_counter_parity(fused, port_fused):
    """The port's "auto" takes the fused path with the plain packed-table
    version on the CPU: the JAX package's "ref" backend."""
    rng = np.random.default_rng(1)
    jeng = JEngine(JWorkflow([PassThroughMapper(), JSumCounter()],
                             external_streams=("S1",)),
                   JConfig(batch_size=16, queue_capacity=64, fused=fused))
    teng = TEngine(TWorkflow([TPassThroughMapper(), TSumCounter()],
                             external_streams=("S1",)),
                   TConfig(batch_size=16, queue_capacity=64,
                           fused=port_fused), device="cpu")
    feeds = [_feed(rng, 16, key_hi=10, t=t) for t in range(6)]
    jst, tst = _run_steps(jeng, teng, feeds)
    jst, dj = jeng.drain(jst)
    tst, dt = teng.drain(tst)
    assert dj == dt > 0
    _eq_state(jst, tst)
    _eq_reads(jeng, jst, teng, tst, "U1", list(range(12)))


def test_sequential_updater_parity_with_deferral():
    """LastValueUpdater: strict per-key order, emissions on S3 (an
    engine output) and hot runs beyond max_run deferred."""
    rng = np.random.default_rng(2)
    jeng, teng = _engines([PassThroughMapper(), LastValueUpdater()],
                          [TPassThroughMapper(), TLastValueUpdater()],
                          batch_size=24, queue_capacity=96)
    feeds = []
    for t in range(6):
        d = _feed(rng, 20, key_hi=2, t=t)
        d["ts"] = rng.integers(0, 50, 20).astype(np.int32)
        feeds.append(d)
    jst, tst = _run_steps(jeng, teng, feeds)
    assert int(tst["deferred"]) > 0
    _eq_state(jst, tst)
    _eq_reads(jeng, jst, teng, tst, "U2", list(range(5)))


@pytest.mark.parametrize("policy", ["drop", "overflow_stream", "throttle"])
def test_overflow_policies(policy):
    class JSecond(PassThroughMapper):
        name = "M2"

    class TSecond(TPassThroughMapper):
        name = "M2"

    class JDegraded(CountingUpdater):
        name = "U_degraded"
        subscribes = ("S_overflow",)

    class TDegraded(TCountingUpdater):
        name = "U_degraded"
        subscribes = ("S_overflow",)

    jp, tp = JPolicy(policy), TPolicy(policy)
    cfg = dict(batch_size=4, queue_capacity=8,
               overflow={"U1": jp} if policy != "throttle" else {"M1": jp})
    tcfg = dict(cfg, overflow={k: tp for k in cfg["overflow"]})
    if policy == "overflow_stream":
        cfg["overflow_stream"] = tcfg["overflow_stream"] = {
            "U1": "S_overflow"}
    jops = [PassThroughMapper(), JSecond(), CountingUpdater(), JDegraded()]
    tops = [TPassThroughMapper(), TSecond(), TCountingUpdater(), TDegraded()]
    ext = ("S1", "S_overflow")
    jeng = JEngine(JWorkflow(jops, external_streams=ext), JConfig(**cfg))
    teng = TEngine(TWorkflow(tops, external_streams=ext), TConfig(**tcfg),
                   device="cpu")
    rng = np.random.default_rng(3)
    feeds = [_feed(rng, 6, key_hi=5, t=t, p_valid=1.0) for t in range(6)]
    jst, tst = _run_steps(jeng, teng, feeds)
    st = teng.stats(tst)
    if policy == "throttle":
        assert st["throttle_hits"] > 0
    elif policy == "drop":
        assert st["queue_dropped"]["U1"] > 0
    else:
        assert st["processed"]["U_degraded"] > 0
    _eq_state(jst, tst)
    _eq_reads(jeng, jst, teng, tst, "U1", list(range(6)))


@pytest.mark.parametrize("fused", ["off", "ref"])
def test_ttl_slot_reuse(fused):
    """Keys idle past the TTL are swept; new keys reuse their slots, and
    the fused path zeroes the dead occupant's values first."""
    class JTtl(JSumCounter):
        ttl = 2
        table_capacity = 37

    class TTtl(TSumCounter):
        ttl = 2
        table_capacity = 37

    jeng, teng = _engines([PassThroughMapper(), JTtl()],
                          [TPassThroughMapper(), TTtl()],
                          batch_size=16, queue_capacity=64, fused=fused)
    rng = np.random.default_rng(4)
    feeds = []
    for t in range(10):
        d = _feed(rng, 12, key_hi=8, t=t, p_valid=1.0)
        d["key"] += 100 * (t // 3)          # a new key band every 3 ticks
        feeds.append(d)
    jst, tst = _run_steps(jeng, teng, feeds)
    _eq_state(jst, tst)
    _eq_reads(jeng, jst, teng, tst, "U1", [0, 3, 100, 205, 300, 307])


def test_run_chunk_bitwise_equal_to_steps_and_to_jax():
    rng = np.random.default_rng(5)
    _, teng = _engines([PassThroughMapper(), LastValueUpdater()],
                       [TPassThroughMapper(), TLastValueUpdater()],
                       batch_size=12, queue_capacity=32)
    jeng = JEngine(JWorkflow([PassThroughMapper(), LastValueUpdater()],
                             external_streams=("S1",)),
                   JConfig(batch_size=12, queue_capacity=32))
    feeds = [_feed(rng, 10, key_hi=6, t=t) for t in range(6)]
    st_steps, outs_steps = teng.init_state(), []
    for d in feeds:
        st_steps, o = teng.step(st_steps, {"S1": _tb(d)})
        outs_steps.append(o)
    st_chunk, outs, info = teng.run_chunk(
        teng.init_state(), t_stack([{"S1": _tb(d)} for d in feeds]))
    _eq_tree(convert.state_to_numpy(st_steps),
             convert.state_to_numpy(st_chunk))
    for i, o in enumerate(outs_steps):
        _eq_tree(convert.to_plain(o["S3"]),
                 convert.to_plain(TBatch(*[x[i] if not isinstance(x, dict)
                                           else {k: v[i] for k, v in
                                                 x.items()}
                                           for x in (outs["S3"].sid,
                                                     outs["S3"].ts,
                                                     outs["S3"].key,
                                                     outs["S3"].value,
                                                     outs["S3"].valid)])))
    jst, jouts, jinfo = jeng.run_chunk(
        jeng.init_state(), j_stack([{"S1": _jb(d)} for d in feeds]))
    _eq_state(jst, st_chunk)
    _eq_tree(convert.to_plain(jouts), convert.to_plain(outs))
    assert np.array_equal(np.asarray(jinfo["throttle_hits"]),
                          info["throttle_hits"].numpy())


def test_run_chunk_ingest_throttling_matches_jax():
    rng = np.random.default_rng(6)
    cfg = dict(batch_size=4, queue_capacity=8,
               overflow={"M1": JPolicy.THROTTLE})
    tcfg = dict(cfg, overflow={"M1": TPolicy.THROTTLE})
    jeng = JEngine(JWorkflow([PassThroughMapper(), CountingUpdater()],
                             external_streams=("S1",)), JConfig(**cfg))
    teng = TEngine(TWorkflow([TPassThroughMapper(), TCountingUpdater()],
                             external_streams=("S1",)), TConfig(**tcfg),
                   device="cpu")
    feeds = [_feed(rng, 12, key_hi=9, t=t, p_valid=1.0) for t in range(8)]
    jst, _, jinfo = jeng.run_chunk(jeng.init_state(),
                                   j_stack([{"S1": _jb(d)} for d in feeds]),
                                   ingest=12, throttle_floor=2)
    tst, _, tinfo = teng.run_chunk(teng.init_state(),
                                   t_stack([{"S1": _tb(d)} for d in feeds]),
                                   ingest=12, throttle_floor=2)
    assert np.array_equal(np.asarray(jinfo["throttle_hits"]),
                          tinfo["throttle_hits"].numpy())
    assert int(jinfo["ingest"]) == int(tinfo["ingest"]) < 12
    _eq_state(jst, tst)


def test_run_with_throttling_matches_jax():
    cfg = dict(batch_size=4, queue_capacity=8,
               overflow={"M1": JPolicy.THROTTLE}, chunk_size=3)
    tcfg = dict(cfg, overflow={"M1": TPolicy.THROTTLE})
    jeng = JEngine(JWorkflow([PassThroughMapper(), CountingUpdater()],
                             external_streams=("S1",)), JConfig(**cfg))
    teng = TEngine(TWorkflow([TPassThroughMapper(), TCountingUpdater()],
                             external_streams=("S1",)), TConfig(**tcfg),
                   device="cpu")
    rng = np.random.default_rng(7)
    feeds = [_feed(rng, 16, key_hi=9, t=t, p_valid=1.0) for t in range(10)]
    sizes = {"j": [], "t": []}

    def source(which, make):
        def fn(t, max_events):
            d = dict(feeds[t])
            take = min(max_events, 16) if max_events else 16
            sizes[which].append(take)
            d["valid"] = np.arange(16) < take
            return {"S1": make(d)}
        return fn

    jst, _ = jeng.run(jeng.init_state(), source("j", _jb), 10)
    handle = StateHandle(teng)
    tst, _ = teng.run(teng.init_state(), source("t", _tb), 10, handle=handle)
    assert sizes["j"] == sizes["t"] and min(sizes["t"]) < 16
    _eq_state(jst, tst)
    assert handle.state is tst
    assert handle.stats() == jeng.stats(jst)
    assert handle.read_slates("U1", [1, 2]) is not None


def test_mid_stream_state_carried_from_jax():
    """Start both engines from one mid-stream JAX state (queues non-empty,
    tables populated), run on, compare."""
    rng = np.random.default_rng(8)
    jeng, teng = _engines([PassThroughMapper(), CountingUpdater(),
                           LastValueUpdater()],
                          [TPassThroughMapper(), TCountingUpdater(),
                           TLastValueUpdater()],
                          batch_size=8, queue_capacity=40)
    jst = jeng.init_state()
    for t in range(4):
        jst, _ = jeng.step(jst, {"S1": _jb(_feed(rng, 14, key_hi=9, t=t))})
    assert int(jst["queues"]["M1"].size) > 0
    tst = convert.state_from_numpy(convert.to_plain(jax.device_get(jst)),
                                   device="cpu")
    _eq_state(jst, tst)
    feeds = [_feed(rng, 14, key_hi=9, t=t) for t in range(4, 8)]
    jst, tst = _run_steps(jeng, teng, feeds, jst, tst)
    _eq_state(jst, tst)
    _eq_reads(jeng, jst, teng, tst, "U1", list(range(10)))


@pytest.mark.parametrize("fused", ["off", "ref"])
def test_int32_int64_key_self_parity(fused):
    """The port's int64 key plane gives the int32 plane's state bit for
    bit on the same key values (the JAX int64 lane needs x64)."""
    rng = np.random.default_rng(9)
    wf = lambda: TWorkflow([TPassThroughMapper(), TSumCounter(),
                            TLastValueUpdater()], external_streams=("S1",))
    e32 = TEngine(wf(), TConfig(batch_size=16, queue_capacity=64,
                                fused=fused), device="cpu")
    e64 = TEngine(wf(), TConfig(batch_size=16, queue_capacity=64,
                                fused=fused, key_dtype="int64"),
                  device="cpu")
    s32, s64 = e32.init_state(), e64.init_state()
    for t in range(6):
        d = _feed(rng, 14, key_hi=12, t=t)
        d["key"][0] = np.iinfo(np.int32).max
        s32, _ = e32.step(s32, {"S1": _tb(d)})
        s64, _ = e64.step(s64, {"S1": _tb(d, torch.int64)})
    assert s64["tables"]["U1"].keys.dtype == torch.int64
    _eq_tree(convert.state_to_numpy(s32), convert.state_to_numpy(s64))
    keys = [0, 5, np.iinfo(np.int32).max, 99]
    assert e32.stats(s32) == e64.stats(s64)
    for a, b in zip(e32.read_slates(s32, "U1", keys),
                    e64.read_slates(s64, "U1", keys)):
        assert (a is None) == (b is None)
        if a is not None:
            _eq_tree({k: v.numpy() for k, v in a.items()},
                     {k: v.numpy() for k, v in b.items()})


def test_device_defaults_to_cuda_and_slices_not_ported_raise(tmp_path):
    wf = TWorkflow([TPassThroughMapper(), TCountingUpdater()],
                   external_streams=("S1",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEngine(wf)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TBatch.of([1, 2], {"x": np.ones(2, np.int32)})
    # durability is ported (slice 6): the engine opens its WAL, store and
    # frontier instead of raising
    from repro_torch.core.durability import DurabilityConfig
    eng = TEngine(wf, TConfig(durability=DurabilityConfig(
        dir=str(tmp_path))), device="cpu")
    assert eng.dur is not None and eng.dur.frontier.tick == 0
    eng.close()
    # telemetry is ported (slice 2): the engine builds its registry and
    # sketch state instead of raising
    from repro_torch.telemetry import TelemetryConfig
    eng = TEngine(wf, TConfig(telemetry=TelemetryConfig()), device="cpu")
    assert eng.telemetry is not None and "sketch" in eng.init_state()


def test_state_handle_reads_only_chunk_boundaries():
    """Reader threads against ``run``: the run updates the state in place
    under ``read_lock``, so a reader only sees chunk boundaries.  Every
    tick feeds key 1 four times and U1 lags M1 by a tick, so boundaries
    of 2-tick chunks read 4 mod 8; a read inside a chunk, or a returned
    slate that still aliases the live table, would read 0 mod 8."""
    import sys
    import threading
    import time
    teng = TEngine(TWorkflow([TPassThroughMapper(), TSumCounter()],
                             external_streams=("S1",)),
                   TConfig(batch_size=8, queue_capacity=32, chunk_size=2),
                   device="cpu")
    handle = StateHandle(teng, teng.init_state())
    feed = _feed(np.random.default_rng(10), 4, p_valid=1.0)
    feed["key"][:] = 1
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            row = handle.read_slate("U1", 1)
            time.sleep(1e-4)
            if row is not None:
                seen.append(int(row["count"]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    threads = [threading.Thread(target=reader) for _ in range(2)]
    try:
        for th in threads:
            th.start()
        teng.run(handle.state, lambda t, m: {"S1": _tb(feed)}, 16,
                 handle=handle)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for th in threads:
            th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert seen and all(c % 8 == 4 for c in seen), sorted(set(seen))
    last = handle.read_slate("U1", 1)
    assert int(last["count"]) == 4 * 15
    # a returned slate is a copy: later in-place ticks leave it alone
    st = handle.state
    for _ in range(2):
        st, _ = teng.step(st, {"S1": _tb(feed)})
    assert int(last["count"]) == 4 * 15
    assert int(teng.read_slate(st, "U1", 1)["count"]) == 4 * 17
