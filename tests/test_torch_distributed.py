"""Port parity: the multi-shard engine (``repro_torch.core.distributed``)
against the JAX ``DistributedEngine`` on the CPU.

The JAX side needs an 8-device host platform, so it runs once, in one
module-scoped subprocess (``tests/_dist_ref.py engine``) that plays every
reference scenario and pickles the results; the port plays the same
numpy feeds here with ``device="cpu"``.  Engine state is compared whole
and bitwise through ``repro_torch.convert`` (queues, so the order in
which each shard received its events, tables, counters, the sketch and
the latency histograms), with ``stats``, ``read_slate`` and
``read_slates``.

Where the reference's own test fails on this JAX (ROADMAP queue 3), the
port is held against the reference paths that pass:
``test_stream_engine_multipod_axes`` — the port's ``("pod", "data")``
mesh is held against the JAX ``("data",)`` run of the same shard count,
which the linearisation must equal; and
``test_read_tier.py::test_distributed_read_slates_parity_plain_and_
partials`` (its Pallas interpret backend is broken) — the port's
``read_slates`` is held against the JAX ``read_slate`` loop and the JAX
``read_slates`` on ``impl="jnp"``.  Also the ring, the mesh and the
differences by design (every shard on one device, a shard count above
the device count, reads that stack the partials)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import hashing as jh
from repro_torch import convert
from repro_torch.core import distributed as dist
from repro_torch.core import hashing as th
from repro_torch.core.distributed import (DistConfig, DistributedEngine,
                                          exchange, make_mesh)
from repro_torch.core.event import EventBatch as TBatch
from repro_torch.core.operators import AssociativeUpdater
from repro_torch.core.workflow import Workflow
from repro_torch.telemetry import TelemetryConfig
from tests import _dist_ref as ref
from tests.test_torch_engine import (TCountingUpdater, TLastValueUpdater,
                                     TMaxCounter, TPassThroughMapper,
                                     TSumCounter, _eq_tree)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return ref.run_reference(tmp_path_factory.mktemp("dist") / "engine.pkl",
                             "engine")


# ---- port-side helpers ----
def tb(d, device="cpu"):
    """A stacked ``[S, B]`` source batch from a feed's numpy arrays."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TBatch(sid=t(np.zeros(d["key"].shape, np.int32)), ts=t(d["ts"]),
                  key=t(d["key"]), value={"x": t(d["x"])},
                  valid=t(d["valid"]))


def engine(ops, shards=8, axes=("data",), **cfg):
    mesh = make_mesh((shards,) if len(axes) == 1 else shards, axes)
    return DistributedEngine(Workflow(list(ops), external_streams=("S1",)),
                             mesh, DistConfig(axis_names=axes, **cfg),
                             device="cpu")


def eq_state(jplain, tstate):
    _eq_tree(jplain, convert.state_to_numpy(tstate))


def eq_read(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        _eq_tree(a, {k: v.numpy() for k, v in b.items()}, what)


def eq_reads(jreads, eng, st, updater, keys=ref.READ_KEYS,
             loop_keys=ref.LOOP_KEYS):
    """The port's per-key and batched reads over ``keys`` against the JAX
    engine's batched reads, and its per-key reads over ``loop_keys``
    against the JAX engine's."""
    looped = {int(k): eng.read_slate(st, updater, int(k)) for k in keys}
    got = eng.read_slates(st, updater, keys)
    for k, a, b, c in zip(keys, jreads["batched"], got, looped.values()):
        eq_read(a, b, f"read_slates {updater} {k}")
        eq_read(a, c, f"read_slate {updater} {k}")
    for k, a in zip(loop_keys, jreads["looped"]):
        eq_read(a, looped[int(k)], f"jax read_slate {updater} {k}")


def steps(eng, fs, st=None):
    st = eng.init_state() if st is None else st
    outs = []
    for d in fs:
        st, o = eng.step(st, {"S1": tb(d)})
        outs.append(o)
    return st, outs


def count_ops():
    return (TPassThroughMapper(), TCountingUpdater(), TLastValueUpdater())


# ---- the ring (tests/test_elasticity.py :28-110, against the JAX ring) --
def _same_ring(j, t):
    assert np.array_equal(j.ring_hashes, t.ring_hashes)
    assert np.array_equal(j.ring_shards, t.ring_shards)
    assert j.real_size == t.real_size


@pytest.mark.parametrize("case", ["fixed_shape", "secondary_pad",
                                  "budget", "shed", "equal_weights"])
def test_ring_matches_jax(case):
    """The five ring cases of the reference, each ring state held
    bitwise against the JAX ``HashRing`` and its routes against
    ``route`` / ``route_secondary`` (int32 and int64 keys)."""
    vn = 32 if case == "fixed_shape" else 64
    j, t = jh.HashRing(8, vnodes=vn), th.HashRing(8, vnodes=vn)
    keys = np.arange(-30_000, 30_000, dtype=np.int32)
    wide = np.arange(2**33, 2**33 + 20_000, dtype=np.int64)

    def same_routes(salt):
        _same_ring(j, t)
        rh, rs = j.table()
        for fn_j, fn_t in ((jh.route, th.route),
                           (jh.route_secondary, th.route_secondary)):
            a = np.asarray(fn_j(jnp.asarray(keys), salt, rh, rs))
            b = fn_t(torch.from_numpy(keys), salt, *t.table()).numpy()
            assert np.array_equal(a, b), fn_t.__name__
        # int64 keys route on the folded hash: the JAX lane needs x64
        want = t.owners(wide, salt)
        h = th._mix32_np(th.fold_u32_np(wide) ^ np.uint32(salt))
        idx = np.searchsorted(j.ring_hashes, h, side="left")
        idx = np.where(idx == len(j.ring_hashes), 0, idx)
        assert np.array_equal(want, j.ring_shards[idx])

    if case == "fixed_shape":
        shape0 = t.table()[0].shape
        for r in (j, t):
            r.fail(3)
            r.join(3)
            r.set_weights(np.array([4.0, 1, 1, 1, 1, 1, 1, 0.25]))
            r.fail(0)
        assert t.table()[0].shape == shape0
        same_routes(5)
        assert 0 not in set(t.owners(keys, 5).tolist())
    elif case == "secondary_pad":
        for s in (4, 5, 6, 7):
            j.fail(s)
            t.fail(s)
        same_routes(42)
        k = torch.from_numpy(keys)
        p = th.route(k, 42, *t.table())
        sec = th.route_secondary(k, 42, *t.table())
        assert (p == sec).double().mean() < 0.001
        assert set(sec.unique().tolist()) <= {0, 1, 2, 3}
    elif case == "budget":
        assert np.array_equal(t.vnode_counts(), j.vnode_counts())
        w = np.array([2.0, 1, 1, 1, 1, 1, 1, 0.5])
        j.set_weights(w)
        t.set_weights(w)
        c = t.vnode_counts()
        assert c.sum() == 8 * 64 and c[0] > 64 > c[7] >= 1
        assert np.array_equal(t.counts_for(w * 3), j.counts_for(w * 3))
        j.fail(2)
        t.fail(2)
        assert t.vnode_counts()[2] == 0
        same_routes(9)
    elif case == "shed":
        before = t.owners(keys, 9)
        w = np.array([0.25, 1, 1, 1, 1, 1, 1, 1])
        j.set_weights(w)
        t.set_weights(w)
        after = t.owners(keys, 9)
        assert (after == 0).mean() < 0.5 * (before == 0).mean()
        assert (before != after).mean() < 0.35
        same_routes(9)
        j.grow(12)
        t.grow(12)
        same_routes(9)
    else:
        assert t.real_size == 8 * 64
        ids = np.repeat(np.arange(8, dtype=np.uint32), 64)
        vix = np.tile(np.arange(64, dtype=np.uint32), 8)
        h = th._mix32_np(ids * np.uint32(0x9E3779B9) ^ th._mix32_np(
            vix + np.uint32(t.seed)))
        order = np.argsort(h, kind="stable")
        assert np.array_equal(t.ring_hashes, h[order])
        same_routes(0)


def test_ring_tables_cached_per_device():
    t = th.HashRing(4)
    a = t.table()
    assert t.table() is a and a[0].dtype == torch.int64
    t.fail(1)
    assert t.table() is not a


# ---- the mesh ----
def test_mesh_and_linear_shard_index():
    """``(pod, data)`` linearises trailing axis fastest, as
    ``_linear_shard_index``; the engine reads only the axis sizes."""
    m = make_mesh((2, 4), ("pod", "data"))
    assert m.shape == {"pod": 2, "data": 4}
    idx = [dist.linear_shard_index({"pod": p, "data": d}, m,
                                   ("pod", "data"))
           for p in range(2) for d in range(4)]
    assert idx == list(range(8))
    assert dist.linear_shard_index({"pod": 1, "data": 2}, m, ("data",)) == 2
    eng = engine(count_ops(), shards=(2, 4), axes=("pod", "data"),
                 batch_size=64, queue_capacity=512)
    assert eng.n_shards == 8
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data",))


# ---- scenarios against the JAX engine ----
def test_counting_exact_and_bitwise(jref):
    """Counting through a mapper on the generic and the sequential path:
    state, per-tick outputs (the sequential updater's S3), drain ticks,
    stats and reads bitwise equal; counts equal a host tally."""
    r = jref["count"]
    eng = engine(count_ops(), batch_size=64, queue_capacity=512)
    fs = ref.feeds(**ref.COUNT)
    st, outs = steps(eng, fs)
    for o_t, o_j in zip(outs, r["outputs"]):
        assert set(o_t) == set(o_j) == {"S3"}
        _eq_tree(o_j["S3"], convert.to_plain(o_t["S3"]))
    st, drained = eng.drain(st)
    assert drained == r["drained"]
    eq_state(r["state"], st)
    assert eng.stats(st) == r["stats"]
    eq_reads(r["reads"], eng, st, "U1")
    truth = np.zeros(64, np.int64)
    for d in fs:
        np.add.at(truth, d["key"][d["valid"]], 1)
    got = [eng.read_slate(st, "U1", k) for k in range(64)]
    assert [0 if g is None else int(g["count"]) for g in got] == \
        truth.tolist()


def test_multi_axis_mesh_equals_the_linear_run(jref):
    """The reference's multipod case fails on this JAX; its
    linearisation says a ``(pod, data) = (2, 4)`` mesh runs as the
    8-shard ``("data",)`` engine, which the port's does, bitwise."""
    eng = engine(count_ops(), shards=(2, 4), axes=("pod", "data"),
                 batch_size=64, queue_capacity=512)
    st, _ = steps(eng, ref.feeds(**ref.COUNT))
    st, _ = eng.drain(st)
    eq_state(jref["count"]["state"], st)


@pytest.mark.parametrize("fused", ["off", "jnp", "ref", "auto"])
def test_run_chunk_and_fused_paths(jref, fused):
    """``run_chunk`` over stacked ``[T, S, B]`` sources, on every fused
    backend (the port's ``auto`` is ``ref`` on the CPU), equals the JAX
    chunk on its packed-table oracle bitwise (its other backends give
    the same state on these integer feeds) and the port's own
    tick-by-tick steps."""
    r = jref["chunk"]
    ops = lambda: (TPassThroughMapper(), TSumCounter(), TMaxCounter())
    fs = ref.feeds(**ref.CHUNK)
    empty = [dict(d, valid=np.zeros_like(d["valid"]), ts=d["ts"] + 900)
             for d in fs[:4]]
    stack = lambda ds: dist._stack([tb(d) for d in ds])
    eng = engine(ops(), batch_size=64, queue_capacity=512, fused=fused)
    st, _, info = eng.run_chunk(eng.init_state(), {"S1": stack(fs)})
    assert tuple(info["throttle_hits"].shape) == r["hits_shape"] == (8, 8)
    st, _, _ = eng.run_chunk(st, {"S1": stack(empty)})
    eq_state(r["state"], st)
    assert eng.stats(st) == r["stats"]
    eng2 = engine(ops(), batch_size=64, queue_capacity=512, fused=fused)
    st2, _ = steps(eng2, fs + empty)
    _eq_tree(convert.state_to_numpy(st), convert.state_to_numpy(st2))


def test_exchange_order_and_drops(jref):
    """The bare exchange against ``exchange`` under ``shard_map``: every
    received field in the collective's order (source major, then bucket
    position) and the drops per source shard, at a cap that overflows."""
    r = jref["exchange"]
    ex = ref.exchange_inputs(**ref.EXCHANGE)
    b = TBatch(sid=torch.from_numpy(ex["sid"]), ts=torch.from_numpy(ex["ts"]),
               key=torch.from_numpy(ex["key"]),
               value={"x": torch.from_numpy(ex["x"])},
               valid=torch.from_numpy(ex["valid"]))
    recv, dropped = exchange(b, torch.from_numpy(ex["dest"]), 8,
                             ref.EXCHANGE["cap"])
    assert tuple(recv.key.shape) == (8, 8 * ref.EXCHANGE["cap"])
    _eq_tree(r["recv"], convert.to_plain(recv))
    assert np.array_equal(dropped.numpy(), r["dropped"])
    assert dropped.sum() > 0


def test_small_slack_drops_equal(jref):
    """A hot key at ``exchange_slack=0.5`` (``cap_per_dest`` 8): the
    same buckets overflow, ``exchange_dropped`` and every queue equal."""
    r = jref["slack"]
    eng = engine((TPassThroughMapper(), TCountingUpdater()), batch_size=64,
                 queue_capacity=512, exchange_slack=0.5)
    assert eng.cap_per_dest == r["cap"] == 8
    st, _ = steps(eng, ref.feeds(**ref.SLACK))
    st, _ = eng.drain(st)
    eq_state(r["state"], st)
    assert eng.stats(st) == r["stats"]
    assert r["stats"]["exchange_dropped"] > 0


def test_fail_shard_reroutes_and_drops_dead_slates(jref):
    r = jref["failover"]
    eng = engine((TPassThroughMapper(), TCountingUpdater()), batch_size=64,
                 queue_capacity=512)
    fs = ref.feeds(**ref.FAIL)
    st, _ = steps(eng, fs[:8])
    st, _ = eng.drain(st)
    assert eng.stats(st) == r["before"]
    st = eng.fail_shard(st, 3)
    eq_state(r["failed"], st)
    assert eng.active_shards == [0, 1, 2, 4, 5, 6, 7]
    st, _ = steps(eng, fs[8:], st)
    st, _ = eng.drain(st)
    eq_state(r["state"], st)
    assert eng.stats(st) == r["stats"]
    assert int((st["tables"]["U1"].keys[3, :-1] != -1).sum()) == 0
    eq_reads(r["reads"], eng, st, "U1")
    load = eng.shard_load(st)
    assert load.shape == (8,) and load[3] == 0


class TCounter1(AssociativeUpdater):
    name = "U1"
    subscribes = ("S1",)
    in_value_spec = {"x": ((), torch.int32)}
    out_streams = {}
    table_capacity = 512

    def slate_spec(self):
        return {"count": ((), torch.int32)}

    def lift(self, b):
        return {"count": torch.ones_like(b.key, dtype=torch.int32)}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"]}

    def merge(self, s, d):
        return {"count": s["count"] + d["count"]}


def test_two_choice_spills_hotspot(jref):
    r = jref["two_choice"]
    eng = engine((TCounter1(),), batch_size=256, queue_capacity=2048,
                 exchange_slack=8.0, two_choice_threshold=4)
    st, _ = steps(eng, ref.feeds(**ref.TWO))
    st, _ = eng.drain(st, 6)
    eq_state(r["state"], st)
    assert eng.stats(st) == r["stats"]
    eq_reads(r["reads"], eng, st, "U1")
    total = sum(int(d["valid"].sum()) for d in ref.feeds(**ref.TWO))
    k7 = st["tables"]["U1"].keys[:, :-1] == 7
    assert int(k7.any(dim=1).sum()) == 2      # partials on two shards
    assert int(eng.read_slate(st, "U1", 7)["count"]) == \
        sum(int(((d["key"] == 7) & d["valid"]).sum())
            for d in ref.feeds(**ref.TWO)) <= total


def test_run_driver_with_telemetry(jref):
    """``run`` in chunks of 8 with a telemetry window of 4: the sources
    seen, the state (sketch and latency histograms included, decayed at
    the same ticks), stats and the last window's report equal the JAX
    tick-by-tick driver's."""
    r = jref["run"]
    eng = engine((TPassThroughMapper(), TCountingUpdater()), batch_size=64,
                 queue_capacity=512, chunk_size=8,
                 telemetry=TelemetryConfig(width=256, window=4))
    fs = ref.feeds(**ref.RUN)
    fed = []

    def src(t, mx):
        fed.append((t, mx))
        return {"S1": tb(fs[t])}

    st, outs = eng.run(eng.init_state(), src, len(fs))
    assert fed == r["fed"] and len(outs) == r["n_outputs"]
    assert eng.tick_cursor == r["cursor"]
    eq_state(r["state"], st)
    assert eng.stats(st) == r["stats"]
    rep, want = eng.telemetry.last, r["report"]
    assert rep.tick == want["tick"]
    assert rep.heavy_hitters == want["heavy"]
    for k, v in (("events", rep.events), ("queue_depth", rep.queue_depth),
                 ("dropped", rep.dropped_delta),
                 ("occupancy", rep.occupancy)):
        assert np.array_equal(v, want[k]), k
    assert rep.event_latency_p99 == want["p99"]


class TRCounter(AssociativeUpdater):
    name = "U1"
    subscribes = ("S1",)
    in_value_spec = {"x": ((), torch.int32)}
    out_streams = {}
    table_capacity = 1024
    sum_mergeable = True

    def slate_spec(self):
        return {"count": ((), torch.int32), "sum": ((), torch.float32)}

    def lift(self, b):
        return {"count": torch.ones_like(b.key, dtype=torch.int32),
                "sum": b.value["x"].to(torch.float32)}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"], "sum": a["sum"] + b["sum"]}

    merge = combine


class TVec(TRCounter):
    name = "UV"

    def slate_spec(self):
        return {"v": ((8,), torch.float32)}

    def lift(self, b):
        return {"v": b.value["x"].to(torch.float32)[:, None].expand(
            b.key.shape[0], 8).clone()}

    def combine(self, a, b):
        return {"v": a["v"] + b["v"]}

    merge = combine


@pytest.mark.parametrize("mode", ["plain", "two_choice", "hot_key"])
def test_read_slates_parity_plain_and_partials(jref, mode):
    """Batched reads (the stacked partials, one host copy) equal the
    per-key ring reads and the JAX reads, bitwise, for plain routing,
    two-choice partials and a hot-key entry (secondary merge)."""
    cfg = dict(batch_size=32, queue_capacity=256, fused="off")
    if mode == "two_choice":
        cfg["two_choice_threshold"] = 4
    eng = engine((TRCounter(), TVec()), shards=4, **cfg)
    st, _ = steps(eng, ref.feeds(**ref.READS))
    st, _ = eng.drain(st)
    r = jref["reads_two" if mode == "two_choice" else "reads_plain"]
    eq_state(r["state"], st)
    if mode == "hot_key":
        eng._hot_keys[0] = 7
        eng._hot_valid[0] = True
        eng._hot_dev = None
        eq_reads(jref["reads_hot"], eng, st, "U1")
        return
    for u in ("U1", "UV"):
        eq_reads(r[u], eng, st, u)
    if mode == "two_choice":
        assert eng.stats(st) == r["stats"]
    assert eng.read_slates(st, "U1", []) == []


# ---- differences by design ----
def test_every_shard_on_one_device_and_reads_stack():
    """All shards live on the engine's one device (the state's leading
    dimension, no per-device placement), and ``read_slates`` makes one
    lookup a shard and stacks the partials (the JAX package's
    ``all_gather``): one ``[S, Q]`` host copy, whatever the shard
    count."""
    eng = engine((TPassThroughMapper(), TCountingUpdater()), shards=16,
                 batch_size=64, queue_capacity=256)
    st = eng.init_state()
    devices = {t.device for t in torch.utils._pytree.tree_leaves(st)}
    assert devices == {torch.device("cpu")}
    assert st["tables"]["U1"].keys.shape == (16, 513)
    st, _ = steps(eng, ref.feeds(seed=4, ticks=3, shards=16, per_shard=8,
                                 key_hi=64))
    from repro_torch.kernels.slate_lookup import ops as lk_ops
    calls = []
    real = lk_ops.lookup_tree

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    lk_ops.lookup_tree = spy
    try:
        got = eng.read_slates(st, "U1", list(range(64)))
    finally:
        lk_ops.lookup_tree = real
    assert len(calls) == 16 and all(c == (513,) for c in calls)
    for k, g in enumerate(got):
        w = eng.read_slate(st, "U1", k)
        eq_read(None if w is None else {f: v.numpy() for f, v in w.items()},
                g, k)


def test_shards_may_exceed_the_device_count():
    """The JAX ``RuntimeConfig.make_mesh`` raises when ``shards`` exceeds
    ``len(jax.devices())``; the port's places every shard on the one
    device, so 16 shards build and run where JAX sees one device."""
    import jax
    from repro_torch.api.runtime import RuntimeConfig
    assert len(jax.devices()) < 16
    rt = RuntimeConfig(shards=16, batch_size=32)
    mesh = rt.make_mesh()
    assert mesh.shape == {"data": 16}
    from repro.api.runtime import RuntimeConfig as JRuntime
    with pytest.raises(ValueError, match="jax device"):
        JRuntime(shards=16).make_mesh()
    eng = DistributedEngine(Workflow([TCounter1()], external_streams=("S1",)),
                            mesh, rt.dist_config(), device="cpu")
    st, _ = steps(eng, ref.feeds(seed=1, ticks=2, shards=16, per_shard=4,
                                 key_hi=16))
    assert eng.stats(st)["processed"]["U1"] == 2 * 16 * 4


def test_step_rejects_sources_on_another_device():
    eng = engine((TCounter1(),), batch_size=16, queue_capacity=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedEngine(eng.wf, eng.mesh, eng.cfg)     # default: cuda
    d = ref.feeds(seed=0, ticks=1, shards=8, per_shard=4, key_hi=8)[0]
    st = eng.init_state()
    st, _ = eng.step(st, {"S1": tb(d)})
    with pytest.raises(ValueError, match="is on meta, the engine on cpu"):
        eng.step(st, {"S1": tb(d, device="meta")})


def _rows_oracle(keys, counts, ts, dirty, owner, cap):
    """The hand oracle of ``exchange_rows`` on a ``[S, C]`` counter
    table: per destination, its stayers and the first ``cap`` movers of
    each source (slot order), a key's rows summed, dirty when folded.
    Returns ({d: {key: (count, ts, dirty)}}, lost per source)."""
    S = keys.shape[0]
    out = {d: {} for d in range(S)}
    lost = np.zeros(S, np.int32)
    for s in range(S):
        sent = np.zeros(S, int)
        for i in np.nonzero(keys[s] != -1)[0]:
            d = int(owner[s, i])
            if d != s:
                if sent[d] == cap:
                    lost[s] += 1
                    continue
                sent[d] += 1
            k = int(keys[s, i])
            row = (int(counts[s, i]), int(ts[s, i]), bool(dirty[s, i]))
            if k in out[d]:
                c0, t0, _ = out[d][k]
                row = (c0 + row[0], max(t0, row[1]), True)
            out[d][k] = row
    return out, lost


def _queue_oracle(q, owner, cap):
    """The hand oracle of ``exchange_queue``: each destination's events in
    (source, dequeue order), at most ``cap`` from a source, then the
    queue capacity.  Returns ({d: [(key, sid, ts, x, valid)]}, drops)."""
    S, Qp = q["key"].shape
    Q = Qp - 1
    out = {d: [] for d in range(S)}
    drops = np.zeros(S, np.int32)
    for s in range(S):
        sent = np.zeros(S, int)
        for r in range(int(q["size"][s])):
            i = (int(q["head"][s]) + r) % Q
            d = int(owner[s, i])
            if sent[d] == cap:
                drops[s] += 1
                continue
            sent[d] += 1
            out[d].append(tuple(int(q[f][s, i]) for f in
                                ("key", "sid", "ts", "x", "valid")))
    for d in range(S):
        if len(out[d]) > Q:
            drops[d] += len(out[d]) - Q
            out[d] = out[d][:Q]
    return out, drops


def _exchange_rows_case():
    """Four shards of a 64-slot counter table; key 5 holds partials on
    shards 0 and 2 (two-choice), key 9 one row; the new ring moves some
    rows and a cap of 2 loses some: the rebuilt tables, drops and
    movers equal the hand oracle's."""
    from repro_torch.slates import table as tbl
    S, C, cap = 4, 64, 2
    rng = np.random.default_rng(4)
    tabs = []
    for s in range(S):
        t = tbl.make_table(C, {"count": ((), torch.int32)}, device="cpu")
        ks = rng.choice(np.arange(100, 400), 12, replace=False)
        ks = np.concatenate([ks, [5] if s in (0, 2) else [],
                             [9] if s == 1 else []]).astype(np.int32)
        q = torch.from_numpy(ks)
        t, slot, _, placed = tbl.insert_or_find(
            t, q, torch.ones(len(ks), dtype=torch.bool))
        assert bool(placed.all())
        t.vals["count"][slot] = torch.from_numpy(
            rng.integers(1, 50, len(ks)).astype(np.int32))
        t.ts[slot] = torch.from_numpy(rng.integers(0, 9, len(ks))
                                      .astype(np.int32))
        t.dirty[slot] = torch.from_numpy(rng.random(len(ks)) < 0.5)
        tabs.append(t)
    st = dist._stack(tabs)
    ring = th.HashRing(S)
    ring.set_weights(np.array([1.0, 0.25, 2.0, 1.0]))
    rh, rs = ring.table()
    salt = dist._salt("U1")
    keys = st.keys[:, :C].numpy()
    owner = th.route(st.keys[:, :C], salt, rh, rs).numpy()
    want, lost = _rows_oracle(keys, st.vals["count"][:, :C].numpy(),
                              st.ts[:, :C].numpy(), st.dirty[:, :C].numpy(),
                              owner, cap)
    movers = ((keys != -1) & (owner != np.arange(S)[:, None])).sum(1)
    new, moved = dist.exchange_rows(st, salt, rh, rs, S, cap,
                                    TCounter1().combine)
    assert moved.tolist() == movers.tolist()
    assert new.dropped.tolist() == lost.tolist()
    assert lost.sum() > 0 and movers.sum() > 0
    for d in range(S):
        k = new.keys[d, :C].numpy()
        got = {int(k[i]): (int(new.vals["count"][d, i]), int(new.ts[d, i]),
                           bool(new.dirty[d, i]))
               for i in np.nonzero(k != -1)[0]}
        assert got == want[d], d
        # every kept row is found where a lookup looks for it
        slot, found = tbl.lookup(tbl.SlateTable(
            keys=new.keys[d], ts=new.ts[d], dirty=new.dirty[d],
            vals={"count": new.vals["count"][d]}, dropped=new.dropped[d]),
            torch.from_numpy(np.asarray(sorted(got), np.int32)))
        assert bool(found.all())
    assert sum(5 in want[d] for d in range(S)) == 1


def _exchange_queue_case():
    """Four shards' queues of 6 slots, wrapped heads, backlogs of 0-6
    events; the new ring re-homes them with a cap of 3 a bucket: each
    rebuilt queue (compacted at head 0), its drops, peak = size, and the
    movers equal the hand oracle's."""
    from repro_torch.core import queues as q_mod
    S, Q, cap = 4, 6, 3
    rng = np.random.default_rng(8)
    qs = []
    for s in range(S):
        q = q_mod.make_queue(Q, {"x": ((), torch.int32)}, device="cpu")
        q.head = torch.tensor(int(rng.integers(0, Q)), dtype=torch.int32)
        q.size = torch.tensor([0, 6, 3, 5][s], dtype=torch.int32)
        q.dropped = torch.tensor(s, dtype=torch.int32)
        for f, hi in (("key", 40), ("sid", 3), ("ts", 20)):
            getattr(q.buf, f)[:Q] = torch.from_numpy(
                rng.integers(0, hi, Q).astype(np.int32))
        q.buf.value["x"][:Q] = torch.from_numpy(
            rng.integers(0, 9, Q).astype(np.int32))
        q.buf.valid[:Q] = torch.from_numpy(rng.random(Q) < 0.8)
        qs.append(q)
    st = dist._stack(qs)
    ring = th.HashRing(S)
    ring.fail(1)
    rh, rs = ring.table()
    salt = dist._salt("U1")
    owner = th.route(st.buf.key, salt, rh, rs).numpy()
    plain = dict(key=st.buf.key.numpy(), sid=st.buf.sid.numpy(),
                 ts=st.buf.ts.numpy(), x=st.buf.value["x"].numpy(),
                 valid=st.buf.valid.numpy(), head=st.head.numpy(),
                 size=st.size.numpy())
    want, drops = _queue_oracle(plain, owner, cap)
    live = np.arange(Q)[None, :] < plain["size"][:, None]
    pos = (plain["head"][:, None] + np.arange(Q)) % Q
    movers = (live & (np.take_along_axis(owner, pos, 1)
                      != np.arange(S)[:, None])).sum(1)
    new, moved = dist.exchange_queue(st, salt, rh, rs, S, cap)
    assert moved.tolist() == movers.tolist() and movers.sum() > 0
    assert new.head.tolist() == [0] * S
    assert new.size.tolist() == [len(want[d]) for d in range(S)]
    assert new.peak.tolist() == new.size.tolist()
    assert new.peak.data_ptr() != new.size.data_ptr()
    assert (new.dropped - st.dropped).tolist() == drops.tolist()
    assert drops.sum() > 0
    for d in range(S):
        n = len(want[d])
        got = list(zip(*[t[d, :n].tolist() for t in (
            new.buf.key, new.buf.sid, new.buf.ts, new.buf.value["x"],
            new.buf.valid.to(torch.int32))]))
        assert got == want[d], d
        assert not bool(new.buf.valid[d, n:Q].any())


@pytest.mark.parametrize("call", [
    "scale", "add_shards", "remove_shards", "rebalance", "clear_split",
    "compact", "_reconfigure", "exchange_rows", "exchange_queue",
    "run_autoscale"])
def test_elasticity_raises_naming_item_15b(call):
    """Live elasticity runs (the calls once raised): each
    method on 8 shards after 4 ticks of a feed keeps every count exact
    and reports what it did; ``exchange_rows`` and ``exchange_queue``
    equal a hand oracle; ``run`` with an ``AutoscalePolicy`` scales."""
    if call == "exchange_rows":
        return _exchange_rows_case()
    if call == "exchange_queue":
        return _exchange_queue_case()
    kw = dict(autoscale=dist.AutoscalePolicy(scale_at={2: 4})) \
        if call == "run_autoscale" else {}
    if call == "clear_split":
        kw = dict(hot_key_capacity=8, telemetry=TelemetryConfig(width=256))
    eng = engine((TCounter1(),), batch_size=32, queue_capacity=512,
                 exchange_slack=8.0, **kw)
    fs = [dict(d, key=np.where(np.arange(16) < 4, 7, d["key"]).astype(
        np.int32)) for d in ref.feeds(seed=3, ticks=4, shards=8,
                                      per_shard=16, key_hi=40)]
    truth = np.zeros(64, np.int64)
    for d in fs:
        np.add.at(truth, d["key"][d["valid"]], 1)

    def src(t, _mx):
        d = fs[t]
        n = eng.n_shards
        return {"S1": tb({k: v.reshape(n, -1) for k, v in d.items()})}

    st = eng.init_state()
    if call == "run_autoscale":
        st, _ = eng.run(st, src, 4)
        assert eng.active_shards == [0, 1, 2, 3] and eng.n_shards == 8
    else:
        if call == "clear_split":
            st, _ = eng.split_keys(st, [7])
        st, _ = eng.run(st, src, 4)
        fn = {"scale": lambda: eng.scale(st, 4),
              "add_shards": lambda: eng.add_shards(st, 2),
              "remove_shards": lambda: eng.remove_shards(st, [7]),
              "rebalance": lambda: eng.rebalance(st),
              "clear_split": lambda: eng.clear_split(st),
              "compact": lambda: eng.compact(eng.remove_shards(
                  st, [6, 7])[0]),
              "_reconfigure": lambda: eng._reconfigure(st, deactivate=[7])
              }[call]
        st, rep = fn()
        want = {"scale": ("device", False, 8, [0, 1, 2, 3]),
                "add_shards": ("host", True, 10, list(range(10))),
                "remove_shards": ("device", False, 8, list(range(7))),
                "rebalance": ("device", False, 8, list(range(8))),
                "clear_split": ("device", False, 8, list(range(8))),
                "compact": ("host", True, 6, list(range(6))),
                "_reconfigure": ("device", False, 8, list(range(7)))}[call]
        assert (rep.path, rep.recompiled, rep.n_shards, rep.active) == want
        assert rep.pause_s > 0
        # compaction renumbers slots; every other call re-homes rows
        assert (sum(rep.moved_rows.values()) > 0) == (call != "compact")
        assert eng.n_shards == want[2] and eng.active_shards == want[3]
        occ = st["tables"]["U1"].occupancy().tolist()
        assert all(occ[s] == 0 for s in range(eng.n_shards)
                   if s not in want[3])
        if call == "clear_split":
            assert eng.split_key_set() == []
            assert int((st["tables"]["U1"].keys[:, :-1] == 7).sum()) == 1
    st, _ = eng.drain(st)
    got = [0 if r is None else int(r["count"])
           for r in eng.read_slates(st, "U1", np.arange(64))]
    assert got == truth.tolist()
    stats = eng.stats(st)
    assert stats["exchange_dropped"] == 0 and stats["queue_dropped"] == {
        "U1": 0}
