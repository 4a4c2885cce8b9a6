"""Port parity of durability and recovery (DESIGN.md section 10): the
port's msgpack subset, codec frames, write-ahead log, KV store, flusher,
durability runtime and ``Engine.recover`` held against the JAX package
on the CPU, the JAX side on ``fused="jnp"``.

Byte formats are equal, not just readable: ``_msgpack.packb`` against
``msgpack.packb``, WAL files and store segment files against the JAX
package's for the same input.  Recovery crosses packages both ways: a
JAX durable run crashed at tick 12 is recovered by the port's
``Engine(device="cpu")`` and run to 24, bitwise equal (slates and their
``ts``) to the JAX uninterrupted run, and the other way round, for
int32 and int64 keys (int64 keys lie past 2**32).  The port's own
counterparts of ``tests/test_recovery.py`` follow, with a subprocess
killed mid-append for the torn tail."""
import os
import signal
import subprocess
import sys

import jax
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import durability as j_dur
from repro.core.engine import Engine as JEngine
from repro.core.engine import EngineConfig as JConfig
from repro.core.event import EventBatch as JBatch
from repro.core.workflow import Workflow as JWorkflow
from repro.slates import _compress as j_compress
from repro.slates import flush as j_flush
from repro.slates import kvstore as j_kv
from repro.slates.wal import WriteAheadLog as JWal
from repro_torch import convert
from repro_torch.core import durability as t_dur
from repro_torch.core.durability import WALAppendError
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.event import EventBatch
from repro_torch.core.queues import OverflowPolicy
from repro_torch.core.workflow import Workflow
from repro_torch.slates import _compress, _msgpack, kvstore
from repro_torch.slates import table as tbl
from repro_torch.slates.flush import (FlushConfig, FlushError, FlushFrontier,
                                      Flusher, FlushPolicy,
                                      begin_dirty_snapshot, dirty_snapshot,
                                      finish_dirty_snapshot, restore_into)
from repro_torch.slates.wal import WriteAheadLog
from tests.conftest import PassThroughMapper
from tests.test_torch_durability_kernel import (KEY_OFFSET, Last, Pass,
                                                Sum, durable_engine, feed,
                                                slates_of, source)
from tests.test_torch_engine import JSumCounter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KDS = [np.int32, np.int64]
kd_ids = lambda kd: np.dtype(kd).name


# ---------------------------------------------------------------- msgpack
_INTS = [0, 1, 2**5 - 1, 2**5, 2**7 - 1, 2**7, 2**8 - 1, 2**8, 2**15,
         2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1,
         2**64 - 1, -1, -2**5, -2**5 - 1, -2**7, -2**7 - 1, -2**15,
         -2**15 - 1, -2**31, -2**31 - 1, -2**63]
_LENGTHS = [0, 1, 31, 32, 255, 256, 65535, 65536]
_CASES = (
    [("int", x) for x in _INTS]
    + [("str", "s" * n) for n in _LENGTHS]
    + [("bin", b"b" * n) for n in _LENGTHS]
    + [("array", list(range(n))) for n in (0, 15, 16, 65535, 65536)]
    + [("map", {i: -i for i in range(n)}) for n in (0, 15, 16, 65536)]
    + [("nil-bool", [None, True, False]), ("utf8", "é" * 40),
       ("nested", {"tick": 7, "src": {"S1": {"key": {
           b"d": b"\x00" * 300, b"t": "<i8", b"s": [37]}}},
           b"k": [(1, 2), [b"", "x", {}]]})])


@pytest.mark.parametrize("obj", [c[1] for c in _CASES],
                         ids=[f"{c[0]}{i}" for i, c in enumerate(_CASES)])
def test_msgpack_packb_byte_equal_and_round_trips(obj):
    raw = _msgpack.packb(obj)
    assert raw == msgpack.packb(obj)
    want = msgpack.unpackb(raw, strict_map_key=False)
    assert _msgpack.unpackb(raw) == want
    assert msgpack.unpackb(_msgpack.packb(want),
                           strict_map_key=False) == want


def test_msgpack_refuses_what_it_does_not_write():
    with pytest.raises(TypeError):
        _msgpack.packb(1.5)
    with pytest.raises(OverflowError):
        _msgpack.packb(2**64)
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")


# ---------------------------------------------------------------- codec
def test_compress_frames_read_across_packages(monkeypatch):
    data = bytes(range(256)) * 40
    assert _compress.HAVE_ZSTD and j_compress.HAVE_ZSTD
    jz = j_compress.Compressor(level=3).compress(data)
    assert jz[:1] == b"z"
    assert _compress.Decompressor().decompress(jz) == data
    raw = _compress.Compressor(level=0).compress(data)
    assert raw[:1] == b"r"
    assert j_compress.Decompressor().decompress(raw) == data
    tz = _compress.Compressor(level=3).compress(data)
    assert tz == jz and j_compress.Decompressor().decompress(tz) == data
    # where zstandard is missing (the machines with a card) the port
    # writes zlib frames; the JAX package reads them
    monkeypatch.setattr(_compress, "HAVE_ZSTD", False)
    g = _compress.Compressor(level=3).compress(data)
    assert g[:1] == b"g"
    assert j_compress.Decompressor().decompress(g) == data


# ---------------------------------------------------------------- WAL
def _records(kd, n=5):
    """n ticks of numpy batches with a nested value tree."""
    out = []
    for t in range(n):
        k, x = feed(t)
        k = np.asarray(k + KEY_OFFSET[kd], kd)
        valid = (x % 3) != 0
        out.append((t, {"S1": dict(
            sid=np.zeros(k.size, np.int32), ts=np.full(k.size, t, np.int32),
            key=k, valid=valid,
            value={"x": x, "y": {"z": np.stack([x, -x], 1).astype(
                np.float32)}})}))
    return out


def _tbatches(rec):
    return {s: EventBatch(**{f: torch.from_numpy(v) if f != "value" else
                             {"x": torch.from_numpy(v["x"]),
                              "y": {"z": torch.from_numpy(v["y"]["z"])}}
                             for f, v in b.items()})
            for s, b in rec.items()}


def _jbatches(rec):
    return {s: JBatch(**b) for s, b in rec.items()}


def _eq_batches(a, b):
    assert set(a) == set(b)
    for s in a:
        for f in ("sid", "ts", "key", "valid"):
            x, y = np.asarray(getattr(a[s], f)), np.asarray(getattr(b[s], f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        lx = jax.tree.leaves(a[s].value)
        ly = jax.tree.leaves(jax.tree.map(np.asarray, b[s].value))
        assert len(lx) == len(ly)
        for x, y in zip(lx, ly):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_wal_byte_equal_and_replays_across_packages(tmp_path, kd):
    recs = _records(kd)
    jw, tw = JWal(str(tmp_path / "j.log")), WriteAheadLog(
        str(tmp_path / "t.log"))
    offs = []
    for t, rec in recs:
        offs.append(jw.append(t, _jbatches(rec)))
        assert tw.append(t, _tbatches(rec)) == offs[-1]
    jw.close()
    tw.close()
    assert (tmp_path / "j.log").read_bytes() == \
        (tmp_path / "t.log").read_bytes()
    # each package replays the other's log, from an offset too
    tj, jt = WriteAheadLog(str(tmp_path / "j.log")), JWal(
        str(tmp_path / "t.log"))
    got_t, got_j = list(tj.replay()), list(jt.replay())
    assert [t for t, _ in got_t] == [t for t, _ in got_j] == list(range(5))
    for (_, a), (_, b), (_, rec) in zip(got_j, got_t, recs):
        _eq_batches(_jbatches(rec), a)
        assert all(v.device.type == "cpu" for v in (b["S1"].key,
                                                     b["S1"].value["x"]))
        _eq_batches(_jbatches(rec), {s: JBatch(**convert.to_plain(x))
                                     for s, x in b.items()})
    assert [t for t, _ in tj.replay(from_offset=offs[2])] == [3, 4]
    assert [t for t, _ in jt.replay(from_offset=offs[2])] == [3, 4]
    assert [t for t, _ in tj.replay(from_tick=4)] == [4]
    tj.close()
    jt.close()


def test_wal_truncate_before_keeps_offsets(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.log"))
    offs = [wal.append(t, source()(t)) for t in range(5)]
    wal.truncate_before(offs[1])              # drop ticks 0..1
    assert [t for t, _ in wal.replay()] == [2, 3, 4]
    assert [t for t, _ in wal.replay(from_offset=offs[2])] == [3, 4]
    assert wal.offset == offs[4]
    wal.close()
    wal2 = WriteAheadLog(str(tmp_path / "w.log"))   # survives reopen
    assert [t for t, _ in wal2.replay(from_offset=offs[2])] == [3, 4]
    wal2.close()
    # the JAX package reads the compacted log at the same offsets
    jw = JWal(str(tmp_path / "w.log"))
    assert [t for t, _ in jw.replay(from_offset=offs[2])] == [3, 4]
    jw.close()


def test_wal_torn_tail_is_trimmed(tmp_path):
    p = str(tmp_path / "w.log")
    wal = WriteAheadLog(p)
    offs = [wal.append(t, source()(t)) for t in range(4)]
    wal.close()
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 7)      # cut inside the last frame
    wal = WriteAheadLog(p)
    assert [t for t, _ in wal.replay()] == [0, 1, 2]
    assert wal.offset == offs[2]
    assert wal.append(9, source()(9)) > offs[2]
    assert [t for t, _ in wal.replay()] == [0, 1, 2, 9]
    wal.close()


# ---------------------------------------------------------------- store
def _rows(rng, kd, n, off=0):
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int64)
    keys = np.asarray(keys + KEY_OFFSET[kd] + off, kd)
    vals = {"v": rng.normal(size=(n, 8)).astype(np.float32),
            "c": {"n": rng.integers(0, 9, n).astype(np.int32)}}
    ts = rng.integers(0, 50, n).astype(np.int32)
    return keys, vals, ts


def _tree_rows(vals, n):
    return [{"v": vals["v"][i], "c": {"n": vals["c"]["n"][i]}}
            for i in range(n)]


def _same_dirs(a, b):
    files = []
    for root, _, fs in os.walk(a):
        for f in fs:
            pa = os.path.join(root, f)
            pb = os.path.join(b, os.path.relpath(pa, a))
            with open(pa, "rb") as x, open(pb, "rb") as y:
                assert x.read() == y.read(), pa
            files.append(pa)
    n_b = sum(len(fs) for _, _, fs in os.walk(b))
    assert n_b == len(files)
    return len(files)


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_store_segments_byte_equal(tmp_path, kd):
    """Rounds of puts, batches larger than the JAX store's 1,024-put
    buffer, three replicas, one down for a round: the segment files are
    the same bytes, and each package scans the other's store."""
    rng = np.random.default_rng(3)
    js = j_kv.KVStore(str(tmp_path / "j"), replicas=3)
    ts_ = kvstore.KVStore(str(tmp_path / "t"), replicas=3)
    prev = None
    for r in range(4):
        if r == 2:
            js.set_replica_down(1)
            ts_.set_replica_down(1)
        if r == 3:
            js.set_replica_down(1, False)
            ts_.set_replica_down(1, False)
        keys, vals, ts = _rows(rng, kd, 2500)
        if prev is not None:
            keys[:700] = prev[:700]     # rewrites: newer and older ts
        prev = keys
        rows = _tree_rows(vals, len(keys))
        js.put_many("U1", zip(keys.tolist(), rows), ts=ts.tolist(), ttl=9)
        js.flush()
        if r % 2:
            ts_.put_rows("U1", keys, vals, ts=ts, ttl=9)
        else:
            ts_.put_many("U1", zip(keys.tolist(), rows), ts=ts.tolist(),
                         ttl=9)
        ts_.flush()
    assert _same_dirs(str(tmp_path / "j"), str(tmp_path / "t")) == 3 * 64
    a = js.scan_records("U1", now=55)
    cross = kvstore.KVStore(str(tmp_path / "j"), replicas=3)
    b = cross.scan_records("U1", now=55)
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        assert a[k][0] == b[k][0]
        assert jax.tree.leaves(a[k][1]) and all(
            x.tobytes() == y.tobytes() for x, y in
            zip(jax.tree.leaves(a[k][1]), jax.tree.leaves(b[k][1])))
    keys, ts, vals = cross.scan_rows("U1", now=55)
    assert keys.tolist() == sorted(a) and ts.tolist() == [
        a[k][0] for k in sorted(a)]
    assert np.array_equal(vals["c"]["n"],
                          [a[k][1]["c"]["n"] for k in sorted(a)])
    jb = j_kv.KVStore(str(tmp_path / "t"), replicas=3).scan_records(
        "U1", now=55)
    assert jb.keys() == a.keys()
    # TTL GC drops the same records from both
    assert js.gc("U1", now=55) == ts_.gc("U1", now=55) > 0
    _same_dirs(str(tmp_path / "j"), str(tmp_path / "t"))


def test_store_quorum_ttl_and_get(tmp_path):
    s = kvstore.KVStore(str(tmp_path / "s"), replicas=3, write_quorum=2,
                        read_quorum=2)
    s.put("U1", 5, {"v": np.arange(3, dtype=np.float32)}, ts=4, ttl=3)
    assert s.get("U1", 5, now=7)["v"].tolist() == [0, 1, 2]
    assert s.get("U1", 5, now=8) is None            # expired
    s.set_replica_down(0)
    s.set_replica_down(1)
    with pytest.raises(IOError, match="read quorum"):
        s.get("U1", 5)
    s.put("U1", 6, {"v": np.zeros(3, np.float32)}, ts=1)
    with pytest.raises(IOError, match="write quorum"):
        s.flush()
    with pytest.raises(ValueError):
        kvstore.KVStore(str(tmp_path / "x"), replicas=2, write_quorum=3)


def test_row_codec_equals_pack_tree_for_every_layout():
    rng = np.random.default_rng(0)
    for vals in ({"v": rng.normal(size=(7, 8)).astype(np.float32)},
                 {"a": np.arange(7, dtype=np.int64),
                  "b": {"c": rng.random((7, 2, 3)) < 0.5}},
                 rng.integers(0, 5, (7, 4)).astype(np.int32)):
        rows = kvstore.RowCodec.of(vals).encode(vals, 7)
        for i, r in enumerate(rows):
            row = jax.tree.map(lambda a: a[i], vals)
            assert r == j_kv._pack_tree(row) == kvstore._pack_tree(row)
        back = kvstore.RowCodec.of(vals).decode(rows)
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(vals)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


# ---------------------------------------------------- cross recovery
def _jax_engine(d, kd, every_k=8):
    wf = JWorkflow([PassThroughMapper(), JSumCounter()],
                   external_streams=("S1",))
    cfg = JConfig(batch_size=32, queue_capacity=128, chunk_size=4,
                  fused="jnp", key_dtype=np.dtype(kd).name,
                  durability=j_dur.DurabilityConfig(
                      dir=d, flush=j_flush.FlushConfig(
                          policy=j_flush.FlushPolicy.EVERY_K,
                          every_k=every_k)))
    return JEngine(wf, cfg)


def _jax_source(kd):
    def f(t, ingest=None):
        k, x = feed(t)
        return {"S1": JBatch.of(np.asarray(k + KEY_OFFSET[kd], kd),
                                {"x": x}, ts=np.full(k.size, t, np.int32))}
    return f


def _jax_slates(state):
    t = jax.device_get(state["tables"]["U1"])
    keys, ts = np.asarray(t.keys), np.asarray(t.ts)
    leaves = [np.asarray(t.vals[k]) for k in sorted(t.vals)]
    return {int(k): (int(ts[i]),) + tuple(v[i].tobytes() for v in leaves)
            for i, k in enumerate(keys) if k != -1}


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
@pytest.mark.parametrize("crashed_in", ["jax", "port"])
def test_cross_recovery_bitwise(tmp_path, kd, crashed_in):
    """A durable run of one package crashed at tick 12, recovered by the
    other and run to 24 equals both packages' uninterrupted runs."""
    n_total, n_crash = 24, 12
    with jax.enable_x64(kd == np.int64):
        ja = _jax_engine(str(tmp_path / "ja"), kd)
        sa, _ = ja.run(ja.init_state(), _jax_source(kd), n_total)
        base, base_tick = _jax_slates(sa), int(sa["tick"])
        ja.close()
        ta = durable_engine(str(tmp_path / "ta"), kd)
        st, _ = ta.run(ta.init_state(), source(kd), n_total)
        assert slates_of(st) == base and int(st["tick"]) == base_tick
        ta.close()

        d = str(tmp_path / "crash")
        if crashed_in == "jax":
            jb = _jax_engine(d, kd)
            jb.run(jb.init_state(), _jax_source(kd), n_crash)
            assert jb.dur.frontier.tick > 0
            jb.close()
            e2 = durable_engine(d, kd)
            s2 = e2.recover()
            s2, _ = e2.run(s2, source(kd), n_total - n_crash,
                           source_offset=n_crash)
            rec, rec_tick = slates_of(s2), int(s2["tick"])
        else:
            tb = durable_engine(d, kd)
            tb.run(tb.init_state(), source(kd), n_crash)
            assert tb.dur.frontier.tick > 0
            tb.close()
            e2 = _jax_engine(d, kd)
            s2 = e2.recover()
            s2, _ = e2.run(s2, _jax_source(kd), n_total - n_crash,
                           source_offset=n_crash)
            rec, rec_tick = _jax_slates(s2), int(s2["tick"])
        e2.close()
    assert rec_tick == base_tick
    assert rec == base


# ------------------------------------- the port's own recovery tests
@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_crash_recover_bitwise_parity(tmp_path, kd):
    n_total, n_crash = 24, 12
    ea = durable_engine(str(tmp_path / "a"), kd)
    sa, _ = ea.run(ea.init_state(), source(kd), n_total)
    base, base_tick = slates_of(sa), int(sa["tick"])
    ea.close()
    eb = durable_engine(str(tmp_path / "b"), kd)
    sb, _ = eb.run(eb.init_state(), source(kd), n_crash)
    assert eb.dur.frontier.tick > 0
    del sb
    eb.close()
    eb2 = durable_engine(str(tmp_path / "b"), kd)
    s2 = eb2.recover()
    s2, _ = eb2.run(s2, source(kd), n_total - n_crash, source_offset=n_crash)
    assert int(s2["tick"]) == base_tick        # drain ticks replay too
    assert slates_of(s2) == base
    eb2.close()


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_recover_uses_store_not_only_wal(tmp_path, kd):
    """After WAL truncation at the frontier, pre-frontier events exist
    only as flushed slates — recovery must come from the store."""
    d = str(tmp_path / "t")
    ea = durable_engine(d, kd, truncate_wal=True)
    sa, _ = ea.run(ea.init_state(), source(kd), 16)
    base = slates_of(sa)
    frontier = ea.dur.frontier
    assert frontier.tick > 0
    first = next(iter(ea.dur.wal.replay()), None)
    if first is not None:
        assert first[0] >= frontier.tick
    ea.close()
    eb = durable_engine(d, kd, truncate_wal=True)
    assert slates_of(eb.recover()) == base
    eb.close()


def _seq_source(kd):
    def f(t, ingest=None):
        rng = np.random.default_rng(7 + t)
        keys = rng.integers(0, 6, size=8) + KEY_OFFSET[kd]
        xs = rng.integers(0, 100, size=8).astype(np.int32)
        return {"S1": EventBatch.of(np.asarray(keys, kd), {"x": xs}, ts=t,
                                    device="cpu")}
    return f


def _seq_engine(d=None, kd=np.int32):
    wf = Workflow([Pass(), Last()], external_streams=("S1",))
    dur = None if d is None else t_dur.DurabilityConfig(
        dir=d, barrier=False,
        flush=FlushConfig(policy=FlushPolicy.EVERY_K, every_k=4))
    return Engine(wf, EngineConfig(batch_size=16, queue_capacity=64,
                                   chunk_size=2, key_dtype=np.dtype(kd).name,
                                   durability=dur), device="cpu")


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_sequential_at_least_once(tmp_path, kd):
    """barrier=False backdates the frontier by replay_slack: replay
    re-applies events already in the snapshot.  Nothing is lost, and
    order-dependent state converges (``last`` exact) — DESIGN.md 10.3."""
    src = _seq_source(kd)
    e0 = _seq_engine(kd=kd)
    s0, _ = e0.run(e0.init_state(), src, 16)
    base = slates_of(s0, "U2")
    d = str(tmp_path / "seq")
    eb = _seq_engine(d, kd)
    eb.run(eb.init_state(), src, 10)
    eb.close()
    e2 = _seq_engine(d, kd)
    s2 = e2.recover()
    s2, _ = e2.run(s2, src, 6, source_offset=10)
    rec = slates_of(s2, "U2")
    e2.close()
    assert set(rec) == set(base)
    dup = 0
    for k in base:
        last_b, n_b = (np.frombuffer(b, np.int32)[0] for b in base[k][1:])
        last_r, n_r = (np.frombuffer(b, np.int32)[0] for b in rec[k][1:])
        assert last_r == last_b and n_r >= n_b
        dup += n_r - n_b
    assert dup > 0


_CRASH_CHILD = """
import os, signal, sys
sys.path[:0] = [{src!r}, {root!r}]
import numpy as np
from repro_torch.slates.wal import WriteAheadLog
from tests.test_torch_durability_kernel import durable_engine, source

class Torn:
    # the file half-writes the next frame, then the process is killed
    def __init__(self, f):
        self.f = f
    def write(self, b):
        self.f.write(b[:len(b) // 2])
        self.f.flush()
        os.kill(os.getpid(), signal.SIGKILL)

append = WriteAheadLog.append
n = [0]
def dying_append(self, tick, sources):
    n[0] += 1
    if n[0] == {kill_at}:
        self._f = Torn(self._f)
    return append(self, tick, sources)
WriteAheadLog.append = dying_append
eng = durable_engine({d!r}, np.{kd})
eng.run(eng.init_state(), source(np.{kd}), 24)
"""


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_crash_during_async_append_trims_torn_tail(tmp_path, kd):
    """A process killed while its writer thread is inside an append: the
    reopened WAL trims the torn frame to the last whole record, and
    resuming from the surviving prefix replays to bitwise parity with an
    uninterrupted run."""
    n_total, kill_at = 24, 13
    ea = durable_engine(str(tmp_path / "a"), kd)
    sa, _ = ea.run(ea.init_state(), source(kd), n_total)
    base = slates_of(sa)
    ea.close()
    d = str(tmp_path / "b")
    code = _CRASH_CHILD.format(src=os.path.join(ROOT, "src"), root=ROOT,
                               d=d, kill_at=kill_at,
                               kd=np.dtype(kd).name)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == -signal.SIGKILL, r.stderr[-3000:]
    wal_path = os.path.join(d, "wal.log")
    size = os.path.getsize(wal_path)
    eb = durable_engine(d, kd)
    assert os.path.getsize(wal_path) < size       # the torn frame is cut
    recs = list(eb.dur.wal.replay())
    m = len(recs)
    assert m == kill_at - 1 and eb.dur.frontier.tick > 0
    s2 = eb.recover()
    s2, _ = eb.run(s2, source(kd), n_total - m, source_offset=m)
    assert slates_of(s2) == base
    eb.close()


def test_async_append_error_surfaces_at_fence(tmp_path):
    eng = durable_engine(str(tmp_path / "e"))

    def broken(tick, sources):
        raise IOError("disk gone")

    eng.dur.wals[0].append = broken
    with pytest.raises(WALAppendError, match="disk gone"):
        eng.run(eng.init_state(), source(), 12)
    assert eng.dur.frontier.tick == 0
    eng.close()


def test_sequential_frontier_covers_async_tail(tmp_path):
    eng = _seq_engine(str(tmp_path / "seqf"))
    eng.run(eng.init_state(), _seq_source(np.int32), 12)
    frontier = eng.dur.frontier
    assert frontier.tick > 0
    all_ticks = [t for t, _ in eng.dur.wal.replay()]
    ticks = [t for t, _ in eng.dur.wal.replay(
        from_offset=frontier.wal_offset)]
    eng.close()
    assert ticks and min(ticks) <= frontier.tick
    assert ticks == all_ticks[len(all_ticks) - len(ticks):]
    assert max(ticks) == max(all_ticks)


class TTLSum(Sum):
    ttl = 6


def _ttl_source(kd):
    def f(t, ingest=None):
        keys = [0, 1] if t else [0, 1, 7]        # key 7 only at tick 0
        return {"S1": EventBatch.of(
            np.asarray(keys, kd) + KEY_OFFSET[kd],
            {"x": np.asarray(keys, np.int32)}, ts=t, device="cpu")}
    return f


def _ttl_engine(d, kd):
    wf = Workflow([Pass(), TTLSum()], external_streams=("S1",))
    return Engine(wf, EngineConfig(
        batch_size=16, queue_capacity=64, chunk_size=2,
        key_dtype=np.dtype(kd).name,
        durability=t_dur.DurabilityConfig(dir=d, flush=FlushConfig(
            policy=FlushPolicy.EVERY_K, every_k=4))), device="cpu")


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_ttl_expiry_after_recover(tmp_path, kd):
    """Recovery restores per-slot ``ts``, so TTL eviction after a crash
    follows the uninterrupted run's schedule."""
    seven = 7 + KEY_OFFSET[kd]
    src = _ttl_source(kd)
    ea = _ttl_engine(str(tmp_path / "a"), kd)
    sa, _ = ea.run(ea.init_state(), src, 14)
    base = slates_of(sa)
    ea.close()
    assert seven not in base and len(base) == 2
    eb = _ttl_engine(str(tmp_path / "b"), kd)
    sb, _ = eb.run(eb.init_state(), src, 5)
    assert seven in slates_of(sb)
    eb.close()
    eb2 = _ttl_engine(str(tmp_path / "b"), kd)
    s2 = eb2.recover()
    s2, _ = eb2.run(s2, src, 9, source_offset=5)
    rec = slates_of(s2)
    eb2.close()
    assert seven not in rec and rec == base


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_restore_into_preserves_per_slot_ts(kd):
    t = tbl.make_table(32, {"count": ((), torch.int32)},
                       key_dtype=torch.int64 if kd == np.int64
                       else torch.int32, device="cpu")
    keys = np.asarray([3, 5], kd) + KEY_OFFSET[kd]
    t = restore_into(t, keys, {"count": np.asarray([30, 50], np.int32)},
                     np.asarray([2, 9], np.int32))
    q = torch.from_numpy(keys)
    slot, found = tbl.lookup(t, q)
    assert bool(found.all()) and not bool(t.dirty.any())
    assert t.ts[slot].tolist() == [2, 9]
    assert t.vals["count"][slot].tolist() == [30, 50]
    t = tbl.expire_ttl(t, now=torch.tensor(10, dtype=torch.int32), ttl=5)
    _, found = tbl.lookup(t, q)
    assert found.tolist() == [False, True]


class _FailingStore:
    bytes_written = 0

    def put_rows(self, *a, **k):
        raise IOError("store down")

    def flush(self):
        pass


def test_flusher_reraises_store_errors():
    fl = Flusher(_FailingStore(), FlushConfig(policy=FlushPolicy.IMMEDIATE))
    t = tbl.make_table(16, {"count": ((), torch.int32)}, device="cpu")
    t, slot, _, placed = tbl.insert_or_find(
        t, torch.tensor([1], dtype=torch.int32), torch.ones(1, dtype=bool))
    t = tbl.write_slates(t, slot, placed,
                         {"count": torch.tensor([5], dtype=torch.int32)}, 1)
    fl.flush_table("U1", t)
    with pytest.raises(FlushError) as ei:
        fl.drain()
    assert isinstance(ei.value.errors[0], IOError)
    fl.drain()
    fl.close()
    assert not fl._thread.is_alive()


def test_frontier_never_advances_past_failed_flush(tmp_path):
    eng = durable_engine(str(tmp_path / "f"))
    eng.dur.flusher.store = _FailingStore()
    eng.dur.store = eng.dur.flusher.store
    with pytest.raises(FlushError):
        eng.run(eng.init_state(), source(), 12)
    assert eng.dur.frontier.tick == 0
    eng.dur.flusher.close()


def test_frontier_file_roundtrip(tmp_path):
    p = str(tmp_path / "FRONTIER.json")
    assert FlushFrontier.load(p) is None
    FlushFrontier(tick=17, wal_offset=[3, 4], meta={"source_tick": 9}).save(p)
    f = FlushFrontier.load(p)
    assert f.tick == 17 and list(f.wal_offset) == [3, 4]
    g = j_flush.FlushFrontier.load(p)          # the JAX package reads it
    assert (g.tick, g.wal_offset, g.meta) == (17, [3, 4],
                                              {"source_tick": 9})


def test_resumed_run_does_not_rethrottle(tmp_path):
    """throttle_hits is cumulative: a second durable run() on carried-over
    state (the shape of every post-recover resume) must not read old
    hits as a fresh backpressure signal."""
    wf = Workflow([Pass(), Sum()], external_streams=("S1",))
    eng = Engine(wf, EngineConfig(
        batch_size=16, queue_capacity=16, chunk_size=1,
        overflow={"M1": OverflowPolicy.THROTTLE},
        durability=t_dur.DurabilityConfig(dir=str(tmp_path))),
        device="cpu")

    def flood(t, ingest=None):
        return {"S1": EventBatch.of(np.arange(32, dtype=np.int32),
                                    {"x": np.ones(32, np.int32)}, ts=t,
                                    device="cpu")}

    state, _ = eng.run(eng.init_state(), flood, 3)
    assert int(state["throttle_hits"]) > 0
    seen = []

    def calm(t, ingest=None):
        seen.append(ingest)
        return {"S1": EventBatch.of(np.arange(4, dtype=np.int32),
                                    {"x": np.ones(4, np.int32)}, ts=t,
                                    device="cpu")}

    state, _ = eng.run(state, calm, 4, source_offset=3)
    assert seen == [None] * 4, seen
    eng.close()


# ---------------------------------------------------------------- pieces
def test_snapshot_covers_rows_below_the_sink_only():
    """A losing insert claimant's key lands in the sink row ``C`` with
    ``dirty`` set; a flush must never write it under that key."""
    t = tbl.make_table(16, {"v": ((), torch.int32)}, device="cpu")
    t, slot, _, placed = tbl.insert_or_find(
        t, torch.tensor([4], dtype=torch.int32), torch.ones(1, dtype=bool))
    tbl.write_slates(t, slot, placed,
                     {"v": torch.tensor([8], dtype=torch.int32)}, 2)
    t.keys[16] = 11
    t.dirty[16] = True
    t.vals["v"][16] = -1
    keys, ts, vals, cleared = dirty_snapshot(t)
    assert keys.tolist() == [4] and vals["v"].tolist() == [8]
    assert ts.tolist() == [2] and not bool(cleared.dirty.any())


def test_snapshot_token_owns_copies():
    """The port's tick writes tables in place: a snapshot begun before
    more writes resolves to the rows as they stood at begin."""
    t = tbl.make_table(16, {"v": ((), torch.int32)}, device="cpu")
    t, slot, _, placed = tbl.insert_or_find(
        t, torch.tensor([1, 2], dtype=torch.int32), torch.ones(2, dtype=bool))
    tbl.write_slates(t, slot, placed, {"v": torch.tensor(
        [10, 20], dtype=torch.int32)}, 3)
    token = begin_dirty_snapshot(t)
    tbl.write_slates(t, slot, placed, {"v": torch.tensor(
        [-1, -2], dtype=torch.int32)}, 4)
    keys, ts, vals = finish_dirty_snapshot(token)
    order = np.argsort(keys)
    assert keys[order].tolist() == [1, 2]
    assert vals["v"][order].tolist() == [10, 20] and ts.tolist() == [3, 3]


def test_auto_replay_slack_matches_jax():
    wf = Workflow([Pass(), Sum()], external_streams=("S1",))
    jwf = JWorkflow([PassThroughMapper(), JSumCounter()],
                    external_streams=("S1",))
    for q, b in ((128, 32), (100, 7), (16, 16)):
        assert t_dur.auto_replay_slack(wf, q, b) == \
            j_dur.auto_replay_slack(jwf, q, b)


def test_per_shard_wals_resize_and_merge_replay(tmp_path):
    """The per-shard WAL set a multi-shard driver uses: appends land in
    their shard's log, ``resize`` grows and shrinks the set behind a
    fence, and ``merge_replay_ticks`` yields what the JAX package's
    merge yields over the same files."""
    wf = Workflow([Pass(), Sum()], external_streams=("S1",))
    cfg = t_dur.DurabilityConfig(dir=str(tmp_path))
    dur = t_dur.EngineDurability(cfg, wf, 128, 32, n_shards=2)
    src = source()
    for t in range(6):
        dur.append(t, src(t), shard=t % 2)
    dur.append(6, src(6), shard=0)
    dur.fence()
    dur.record_frontier(3)
    offs = dur.frontier_offsets()
    assert len(offs) == 2
    dur.resize(3)
    assert len(dur.wals) == 3 and len(dur.frontier_offsets()) == 3
    dur.append(7, src(7), shard=2)
    dur.fence()
    got = [(t, sorted(by)) for t, by in t_dur.merge_replay_ticks(
        dur.wals, [0, 0, 0])]
    jw = [JWal(cfg.wal_path(s)) for s in range(3)]
    want = [(t, sorted(by)) for t, by in j_dur.merge_replay_ticks(
        jw, [0, 0, 0])]
    assert got == want == [(0, [0]), (1, [1]), (2, [0]), (3, [1]),
                           (4, [0]), (5, [1]), (6, [0]), (7, [2])]
    for w in jw:
        w.close()
    dur.resize(1)
    assert len(dur.wals) == 1
    assert FlushFrontier.load(cfg.frontier_path()).wal_offset == offs[:1]
    dur.close()
    with pytest.raises(AttributeError):
        t_dur.EngineDurability(cfg, wf, 128, 32, n_shards=1).wal


def test_engine_durability_due_and_barrier_less_frontier(tmp_path):
    wf = Workflow([Pass(), Sum()], external_streams=("S1",))
    for policy, want in ((FlushPolicy.IMMEDIATE, [1, 2, 3, 4, 5]),
                         (FlushPolicy.EVERY_K, [4, 5])):
        d = str(tmp_path / policy.value)
        dur = t_dur.EngineDurability(t_dur.DurabilityConfig(
            dir=d, flush=FlushConfig(policy=policy, every_k=4)), wf, 64, 16)
        assert [t for t in range(1, 6) if dur.due(t)] == want
        dur.close()
    dur = t_dur.EngineDurability(t_dur.DurabilityConfig(
        dir=str(tmp_path / "nb"), barrier=False, replay_slack=2), wf, 64, 16)
    src = source()
    for t in range(6):
        dur.append(t, src(t))
    dur.fence()
    dur.record_frontier(5)
    # backdated by the slack: the frontier replays from tick 3's append
    assert dur.frontier.tick == 3
    assert [t for t, _ in dur.wal.replay(
        from_offset=dur.frontier.wal_offset)] == [3, 4, 5]
    dur.close()


# -------------------------------- durability and telemetry together
def test_durable_run_with_telemetry_crash_recover_across_packages(tmp_path):
    """Both packages run the durable engine with ``TelemetryConfig(
    window=4)`` (the JAX side on ``fused="jnp"``), crash at tick 12,
    recover, and resume to 24: the states, sketch and latency histograms
    included, equal across packages at each stage, and so do the
    uninterrupted runs' last reports.  ``recover`` restarts the
    telemetry state from ``init_state()`` in both packages (the
    reference's behaviour), so the resumed run's ``lat_hist`` differs
    from the uninterrupted run's, in both packages alike."""
    from repro.telemetry.metrics import TelemetryConfig as JTelemetry
    from repro_torch.telemetry.metrics import TelemetryConfig
    from tests.test_torch_telemetry import _eq_report
    n_total, n_crash = 24, 12

    def j_engine(d):
        wf = JWorkflow([PassThroughMapper(), JSumCounter()],
                       external_streams=("S1",))
        return JEngine(wf, JConfig(
            batch_size=32, queue_capacity=128, chunk_size=4, fused="jnp",
            telemetry=JTelemetry(window=4),
            durability=j_dur.DurabilityConfig(
                dir=d, flush=j_flush.FlushConfig(
                    policy=j_flush.FlushPolicy.EVERY_K, every_k=8))))

    def t_engine(d):
        wf = Workflow([Pass(), Sum()], external_streams=("S1",))
        return Engine(wf, EngineConfig(
            batch_size=32, queue_capacity=128, chunk_size=4,
            telemetry=TelemetryConfig(window=4),
            durability=t_dur.DurabilityConfig(
                dir=d, flush=FlushConfig(policy=FlushPolicy.EVERY_K,
                                         every_k=8))), device="cpu")

    def same(jstate, tstate):
        a = convert.to_plain(jax.device_get(jstate))
        b = convert.state_to_numpy(tstate)
        fa, _ = jax.tree.flatten(a)
        fb, _ = jax.tree.flatten(b)
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(fa, fb):
            assert np.array_equal(np.asarray(x), np.asarray(y))

    stages = {}
    for pkg, make, src in (("jax", j_engine, _jax_source(np.int32)),
                           ("port", t_engine, source(np.int32))):
        full = make(str(tmp_path / pkg / "full"))
        s_full, _ = full.run(full.init_state(), src, n_total)
        report = full.telemetry.last
        full.close()
        crash = make(str(tmp_path / pkg / "crash"))
        crash.run(crash.init_state(), src, n_crash)
        assert crash.dur.frontier.tick > 0
        crash.close()
        rec = make(str(tmp_path / pkg / "crash"))
        s_rec = rec.recover()
        # copies: the resumed run updates the port's state in place, and
        # numpy views of CPU tensors share their memory
        rec_plain = jax.tree.map(np.array, (
            convert.to_plain(jax.device_get(s_rec)) if pkg == "jax"
            else convert.state_to_numpy(s_rec)))
        s_res, _ = rec.run(s_rec, src, n_total - n_crash,
                           source_offset=n_crash)
        rec.close()
        stages[pkg] = dict(full=s_full, report=report, rec=rec_plain,
                           res=s_res)

    j, t = stages["jax"], stages["port"]
    same(j["full"], t["full"])
    _eq_report(j["report"], t["report"])
    eq = lambda a, b: jax.tree.all(jax.tree.map(
        lambda x, y: np.array_equal(np.asarray(x), np.asarray(y)), a, b))
    assert eq(j["rec"], t["rec"])
    same(j["res"], t["res"])
    # the resumed run's slates equal the uninterrupted run's; its latency
    # histograms restarted at recovery, in both packages
    assert slates_of(t["res"]) == slates_of(t["full"])
    for pkg in (j, t):
        full = convert.to_plain(jax.device_get(pkg["full"]))
        res = convert.to_plain(jax.device_get(pkg["res"]))
        assert not np.array_equal(full["lat_hist"]["U1"]["counts"],
                                  res["lat_hist"]["U1"]["counts"])
    assert eq(convert.to_plain(jax.device_get(j["res"]))["lat_hist"],
              convert.state_to_numpy(t["res"])["lat_hist"])
