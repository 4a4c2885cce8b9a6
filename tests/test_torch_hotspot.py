"""Port parity: hotspot key splitting (``repro_torch.core.hotspot``) and
the engine's runtime hot-key split, against the JAX package on the CPU.

Sub-key arithmetic (``split_keys`` / ``merge_keys`` / ``subkeys_of``)
and ``KeySplitMapper`` are held bitwise against the JAX functions in
this process, as are ``read_split_slate`` on the single-shard engine and
on a one-shard ``DistributedEngine`` (a one-device JAX mesh).  The
multi-shard cases — ``DistributedEngine.split_keys`` with the telemetry
sketch on, and split sub-keys read through the ring — run the JAX side
in one module-scoped 8-device subprocess (``tests/_dist_ref.py
hotspot``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import hotspot as jhs
from repro.core.distributed import DistConfig as JDistConfig
from repro.core.distributed import DistributedEngine as JDistEngine
from repro.core.engine import Engine as JEngine
from repro.core.engine import EngineConfig as JConfig
from repro.core.event import EventBatch as JBatch
from repro.core.workflow import Workflow as JWorkflow
from repro_torch import convert
from repro_torch.core import hotspot as ths
from repro_torch.core.distributed import (DistConfig, DistributedEngine,
                                          make_mesh)
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.event import EventBatch
from repro_torch.core.hashing import route, route_secondary
from repro_torch.core.workflow import Workflow
from repro_torch.telemetry import TelemetryConfig
from tests import _dist_ref as ref
from tests.conftest import VSPEC, CountingUpdater
from tests.test_torch_distributed import (TRCounter, engine, eq_read,
                                          eq_reads, eq_state, steps, tb)
from tests.test_torch_engine import TCountingUpdater, _eq_tree

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1
TVSPEC = {"x": ((), torch.int32)}


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return ref.run_reference(tmp_path_factory.mktemp("hot") / "hot.pkl",
                             "hotspot")


# ---- sub-key arithmetic ----
@pytest.mark.parametrize("ways", [2, 3, 8, 64])
@pytest.mark.parametrize("kd", [np.int32, np.int64], ids=["i32", "i64"])
def test_split_merge_bitwise_and_round_trips(ways, kd):
    """``split_keys`` equals the JAX function bit for bit (its int32
    products wrap), over random keys, ts spanning int32 and the edges;
    ``merge_keys`` inverts it inside the window and at the extremes."""
    rng = np.random.default_rng(ways)
    info = np.iinfo(kd)
    w = ths.split_window(ways, np.dtype(kd).itemsize * 8)
    edges = np.array([0, 1, -1, 17, w - 1, -(w - 1), w, -w, info.max,
                      info.min, info.min + 1, 2**30, -(2**30)], kd)
    keys = np.concatenate([edges, rng.integers(-w, w, 3000).astype(kd),
                           rng.integers(info.min, info.max, 3000,
                                        dtype=kd)])
    ts = rng.integers(I32_MIN, I32_MAX, keys.size).astype(np.int32)
    got = ths.split_keys(torch.from_numpy(keys), torch.from_numpy(ts), ways)
    back = ths.merge_keys(got, ways).numpy()
    if kd == np.int32:
        want = np.asarray(jhs.split_keys(jnp.asarray(keys), jnp.asarray(ts),
                                         ways))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(back, np.asarray(jhs.merge_keys(
            jnp.asarray(want), ways)))
    else:
        with jax.enable_x64(True):
            want = np.asarray(jhs.split_keys(jnp.asarray(keys),
                                             jnp.asarray(ts), ways))
            assert np.array_equal(got.numpy(), want)
            assert np.array_equal(back, np.asarray(jhs.merge_keys(
                jnp.asarray(want), ways)))
    exact = (np.abs(keys.astype(np.float64)) < w) | \
        (np.abs(keys.astype(np.float64)) >= 2.0**(8 * keys.itemsize - 2))
    assert np.array_equal(back[exact], keys[exact])


@pytest.mark.parametrize("ways", [8])
def test_old_wrap_collision_pair_no_longer_collides(ways):
    a, b = set(ths.subkeys_of(2**28, ways)), set(ths.subkeys_of(-2**28, ways))
    assert not (a & b)
    hot = set(ths.subkeys_of(5, ways))
    for k in (I32_MAX, I32_MIN, 2**30):
        assert not (hot & set(ths.subkeys_of(k, ways)))
        assert ths.subkeys_of(k, ways) == jhs.subkeys_of(k, ways)
    assert ths.subkeys_of(7, ways, 64) == jhs.subkeys_of(7, ways, 64)
    assert ths.split_window(ways) == jhs.split_window(ways)
    with pytest.raises(ValueError):
        ths.split_window(0)


def test_key_split_mapper_spreads_and_matches_jax():
    ways = 8
    keys = np.array([7] * 64 + [I32_MAX, I32_MIN], np.int32)
    ts = np.arange(keys.size, dtype=np.int32) % 5
    valid = np.arange(keys.size) % 7 != 3
    jm = jhs.KeySplitMapper("S1", "S2", VSPEC, ways=ways, name="M1")
    tm = ths.KeySplitMapper("S1", "S2", TVSPEC, ways=ways, name="M1")
    assert (tm.subscribes, set(tm.out_streams)) == (jm.subscribes,
                                                    set(jm.out_streams))
    jo = jm.map_batch(JBatch.of(jnp.asarray(keys), {"x": jnp.asarray(keys)},
                                ts=jnp.asarray(ts), valid=jnp.asarray(valid)))
    to = tm.map_batch(EventBatch.of(torch.from_numpy(keys),
                                    {"x": torch.from_numpy(keys)},
                                    ts=torch.from_numpy(ts),
                                    valid=torch.from_numpy(valid)))
    _eq_tree(convert.to_plain(jax.device_get(jo["S2"])),
             convert.to_plain(to["S2"]))
    split = to["S2"].key[:64].numpy()
    assert len(np.unique(split)) >= 4
    assert set(split.tolist()) <= set(ths.subkeys_of(7, ways))
    assert to["S2"].key[64:].tolist() == [I32_MAX, I32_MIN]


class TSplitCounter(TCountingUpdater):
    subscribes = ("S2",)


def _workflows(ways):
    class JSplitCounter(CountingUpdater):
        subscribes = ("S2",)
    jw = JWorkflow([jhs.KeySplitMapper("S1", "S2", VSPEC, ways=ways,
                                       name="M1"), JSplitCounter()],
                   external_streams=("S1",))
    tw = Workflow([ths.KeySplitMapper("S1", "S2", TVSPEC, ways=ways,
                                      name="M1"), TSplitCounter()],
                  external_streams=("S1",))
    return jw, tw


def _feed_both(jeng, jst, teng, tst, keys, shards=None):
    keys = np.asarray(keys, np.int32)
    ts = np.zeros(keys.size, np.int32)
    jb = JBatch.of(jnp.asarray(keys), {"x": jnp.ones(keys.size, jnp.int32)},
                   ts=jnp.asarray(ts))
    b = EventBatch.of(torch.from_numpy(keys),
                      {"x": torch.ones(keys.size, dtype=torch.int32)},
                      ts=torch.from_numpy(ts), device="cpu")
    if shards:
        jb = jax.tree.map(lambda x: x[None], jb)
        b = EventBatch(b.sid[None], b.ts[None], b.key[None],
                       {"x": b.value["x"][None]}, b.valid[None])
    jst, _ = jeng.step(jst, {"S1": jb})
    tst, _ = teng.step(tst, {"S1": b})
    return jst, tst


@pytest.mark.parametrize("which", ["engine", "distributed_one_shard"])
def test_read_split_slate_matches_jax(which):
    """``read_split_slate`` on the single-shard engine and through the
    ring of a one-shard ``DistributedEngine`` (the JAX test's one-device
    mesh): the merged partials, bitwise, and state equal."""
    ways = 8
    jw, tw = _workflows(ways)
    if which == "engine":
        jeng = JEngine(jw, JConfig(batch_size=64, queue_capacity=256))
        teng = Engine(tw, EngineConfig(batch_size=64, queue_capacity=256),
                      device="cpu")
        keys, shards = [7] * 40 + [I32_MAX] * 8 + [I32_MIN] * 8, None
    else:
        from jax.sharding import Mesh
        jeng = JDistEngine(jw, Mesh(np.asarray(jax.devices()[:1]),
                                    ("data",)),
                           JDistConfig(batch_size=64, queue_capacity=256))
        teng = DistributedEngine(tw, make_mesh((1,), ("data",)),
                                 DistConfig(batch_size=64,
                                            queue_capacity=256),
                                 device="cpu")
        keys, shards = [7] * 24 + [I32_MIN] * 4, 1
    jst, tst = _feed_both(jeng, jeng.init_state(), teng, teng.init_state(),
                          keys, shards)
    for _ in range(3):
        if shards:
            jst = jeng._step_empty(jst)
            tst = teng._step_empty(tst)
        else:
            jst, _ = jeng.step(jst, {})
            tst, _ = teng.step(tst, {})
    _eq_tree(convert.to_plain(jax.device_get(jst)),
             convert.state_to_numpy(tst))
    for k in (7, I32_MAX, I32_MIN, 12345):
        a = jhs.read_split_slate(jeng, jst, "U1", k, ways)
        b = ths.read_split_slate(teng, tst, "U1", k, ways)
        eq_read(None if a is None else jax.tree.map(np.asarray, a), b, k)
    assert int(ths.read_split_slate(teng, tst, "U1", 7, ways)["count"]) == \
        (40 if shards is None else 24)


def test_read_split_slate_named_errors():
    _, tw = _workflows(4)
    eng = Engine(tw, EngineConfig(batch_size=8, queue_capacity=32),
                 device="cpu")
    st = eng.init_state()
    with pytest.raises(ths.SplitSlateReadError, match="unknown updater"):
        ths.read_split_slate(eng, st, "nope", 1, 4)
    with pytest.raises(ths.SplitSlateReadError, match="read_slate"):
        ths.read_split_slate(object(), st, "U1", 1, 4)
    with pytest.raises(ths.SplitSlateReadError, match="no combine"):
        ths.read_split_slate(eng, st, "M1", 1, 4)


# ---- multi-shard, against the 8-device JAX subprocess ----
def _split_engine():
    return engine((TRCounter(),), shards=4, batch_size=64,
                  queue_capacity=2048, exchange_slack=16.0,
                  hot_key_capacity=8, telemetry=TelemetryConfig(width=256))


def test_split_keys_on_the_engine(jref):
    """``split_keys`` after 3 ticks: the hot key's later events alternate
    between its primary and secondary shard; state (sketch included),
    stats and every read equal the JAX engine's, and ``read_slate``
    merges the two partials to the fed count."""
    r = jref["split"]
    eng = _split_engine()
    fs = ref.feeds(**ref.SPLIT)
    hot = ref.SPLIT["hot"]
    st, _ = steps(eng, fs[:3])
    st, none = eng.split_keys(st, [hot])
    assert none is None and eng.split_key_set() == r["split_set"] == [hot]
    st, _ = steps(eng, fs[3:], st)
    for _ in range(4):
        st = eng._step_empty(st)
    eq_state(r["state"], st)
    assert eng.stats(st) == r["stats"]
    eq_reads(r["reads"], eng, st, "U1")
    k = torch.tensor([hot], dtype=torch.int32)
    p = int(route(k, _salt("U1"), *eng.ring.table())[0])
    s = int(route_secondary(k, _salt("U1"), *eng.ring.table())[0])
    keys = st["tables"]["U1"].keys[:, :-1]
    assert p != s and bool((keys[p] == hot).any()) and \
        bool((keys[s] == hot).any())
    fed = sum(int(((d["key"] == hot) & d["valid"]).sum()) for d in fs)
    assert int(eng.read_slate(st, "U1", hot)["count"]) == fed
    assert eng.heat_owners([hot]).tolist() == [[p]]


def _salt(name):
    from repro_torch.core.distributed import _salt as salt
    return salt(name)


def test_split_keys_preconditions():
    eng = engine((TRCounter(),), shards=4, batch_size=16,
                 queue_capacity=64)
    with pytest.raises(ValueError, match="hot_key_capacity"):
        eng.split_keys(eng.init_state(), [1])
    one = engine((TRCounter(),), shards=1, batch_size=16, queue_capacity=64,
                 hot_key_capacity=2, telemetry=TelemetryConfig())
    st, rep = one.split_keys(one.init_state(), [1])
    assert rep is None and one.split_key_set() == []
    eng = _split_engine()
    st = eng.init_state()
    st, _ = eng.split_keys(st, list(range(12)))
    assert eng.split_key_set() == list(range(8))     # capacity 8
    # clear_split converges the partials: each key whole on
    # its owner shard again, the fed count kept
    fs = ref.feeds(**ref.SPLIT)
    st, _ = steps(eng, fs, st)
    for _ in range(4):
        st = eng._step_empty(st)
    before = eng.read_slates(st, "U1", np.arange(32))
    keys = st["tables"]["U1"].keys[:, :-1]
    assert max(int((keys == k).sum()) for k in range(8)) == 2
    st, rep = eng.clear_split(st)
    assert rep.path == "device" and eng.split_key_set() == []
    keys = st["tables"]["U1"].keys[:, :-1]
    assert all(int((keys == k).sum()) <= 1 for k in range(32))
    for k, (a, b) in enumerate(zip(before, eng.read_slates(
            st, "U1", np.arange(32)))):
        eq_read(a and {f: v.numpy() for f, v in a.items()}, b, k)
    assert eng.clear_split(st) == (st, None)         # nothing split


def test_split_sub_keys_read_through_the_ring(jref):
    """``KeySplitMapper`` in front of a counter on 4 shards: every
    sub-key reads the same batched and looped, and as the JAX engine;
    ``read_split_slate`` merges them as JAX does."""
    r = jref["split_reads"]
    ways, hot = 4, ref.SPLIT_READS["hot"]
    eng = DistributedEngine(
        Workflow([ths.KeySplitMapper("S1", "S2", TVSPEC, ways=ways),
                  type("C", (TRCounter,), {"subscribes": ("S2",)})()],
                 external_streams=("S1",)),
        make_mesh((4,), ("data",)),
        DistConfig(batch_size=32, queue_capacity=512, fused="off"),
        device="cpu")
    st, _ = steps(eng, ref.feeds(**ref.SPLIT_READS))
    st, _ = eng.drain(st)
    eq_state(r["state"], st)
    assert eng.stats(st) == r["stats"]
    subs = ths.subkeys_of(hot, ways)
    assert np.array_equal(subs, r["subs"])
    looped = [eng.read_slate(st, "U1", k) for k in subs]
    batched = eng.read_slates(st, "U1", subs)
    assert sum(v is not None for v in looped) >= 2     # really split
    for k, a, b, c in zip(subs, r["reads"]["looped"], looped, batched):
        eq_read(a, b, k)
        eq_read(a, c, k)
    eq_read(r["merged"], ths.read_split_slate(eng, st, "U1", hot, ways),
            "merged")
    for k, a in enumerate(r["merged_cold"]):
        eq_read(a, ths.read_split_slate(eng, st, "U1", k, ways), k)
