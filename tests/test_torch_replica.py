"""The port's ``SlateReplica`` (DESIGN.md section 15): stale-bounded
reads from flush-frontier snapshots, held against the live engine and
against the JAX package's replica reading the same store.  The port's
counterparts of ``tests/test_read_tier.py``'s replica cases: the
staleness bound across a crash and recovery, and an incremental
(flush-delta) refresh equal to a full store scan, bitwise, TTL pruning
included; int32 and int64 keys (int64 keys past 2**32)."""
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.workflow import Workflow as JWorkflow
from repro.slates import kvstore as j_kv
from repro.slates.replica import SlateReplica as JReplica
from repro_torch.slates.replica import SlateReplica, StaleReplicaError
from tests.conftest import CountingUpdater, PassThroughMapper
from tests.test_torch_durability_kernel import (KEY_OFFSET, Pass, Sum,
                                                durable_engine, source)

KDS = [np.int32, np.int64]
kd_ids = lambda kd: np.dtype(kd).name


def _src(kd, seed, n_keys):
    return source(kd, seed=seed, n_keys=n_keys)


def _eq_slate(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert set(a) == set(b)
        for leaf in a:
            x, y = np.asarray(a[leaf]), np.asarray(b[leaf])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_replica_staleness_bound_across_crash_recovery(tmp_path, kd):
    d = str(tmp_path / "d")
    src = _src(kd, 300, 30)
    keys = [k + KEY_OFFSET[kd] for k in range(30)]
    eng = durable_engine(d, kd, every_k=4)
    state, _ = eng.run(eng.init_state(), src, 12)
    state = eng.checkpoint(state)
    rep = SlateReplica(eng.dur.store, eng.wf, max_staleness_ticks=8)
    with pytest.raises(StaleReplicaError):
        rep.read("U1", keys[0], now=0)       # never refreshed
    rep.refresh(eng.dur.frontier)
    tick = rep.snapshot_tick
    assert tick > 0
    live = [(k, eng.read_slate(state, "U1", k)) for k in keys]
    assert sum(v is not None for _, v in live) > 20
    for k, lv in live:
        _eq_slate(rep.read("U1", k, now=tick),
                  None if lv is None else {f: v.numpy()
                                           for f, v in lv.items()})
    with pytest.raises(StaleReplicaError):
        rep.read("U1", keys[0], now=tick + 9)
    eng.close()

    # the crash: a fresh engine recovers from the same store; a replica
    # over it serves what the recovered engine holds
    eng2 = durable_engine(d, kd, every_k=4)
    s2 = eng2.recover()
    rep2 = SlateReplica(eng2.dur.store, eng2.wf, max_staleness_ticks=8)
    rep2.refresh(eng2.dur.frontier)
    got = rep2.read_many("U1", keys, now=rep2.snapshot_tick)
    for k, rv in zip(keys, got):
        lv = eng2.read_slate(s2, "U1", k)
        _eq_slate(rv, None if lv is None else {f: v.numpy()
                                               for f, v in lv.items()})
    s2, _ = eng2.run(s2, src, 12, source_offset=12)
    s2 = eng2.checkpoint(s2)
    now = int(eng2.dur.frontier.tick)
    assert now - rep2.snapshot_tick > 8
    with pytest.raises(StaleReplicaError):
        rep2.read("U1", keys[0], now=now)
    rep2.refresh(eng2.dur.frontier)
    for k, rv in zip(keys, rep2.read_many("U1", keys, now=now)):
        lv = eng2.read_slate(s2, "U1", k)
        _eq_slate(rv, None if lv is None else {f: v.numpy()
                                               for f, v in lv.items()})
    assert rep2.stats()["snapshot_tick"] == now
    eng2.close()


class TtlSum(Sum):
    name = "U2"
    ttl = 6


class JTtlCounting(CountingUpdater):
    name = "U2"
    ttl = 6


@pytest.mark.parametrize("kd", KDS, ids=kd_ids)
def test_replica_incremental_refresh_matches_full_scan(tmp_path, kd):
    """A delta-fed replica refreshed at every frontier holds the snapshot
    (keys, write ticks, values — bitwise) a fresh full-store scan at that
    frontier builds, TTL pruning included; the JAX package's replica
    scanning the port's store builds the same."""
    d = str(tmp_path / "d")
    eng = durable_engine(d, kd, ops=[Pass(), Sum(), TtlSum()], every_k=4,
                         track_flush_deltas=True)
    jwf = JWorkflow([PassThroughMapper(), CountingUpdater(),
                     JTtlCounting()], external_streams=("S1",))
    src = _src(kd, 40, 50)
    keys = [k + KEY_OFFSET[kd] for k in range(50)]
    state = eng.init_state()
    inc = SlateReplica(eng.dur.store, eng.wf, max_staleness_ticks=64,
                       flusher=eng.dur.flusher)
    for seg in range(4):
        # the feed thins out so TTL-expired rows leave U2's snapshot
        n = 4 if seg < 2 else 1
        state, _ = eng.run(state, src, n, source_offset=seg * 4)
        state = eng.checkpoint(state)
        inc.refresh(eng.dur.frontier)
        full = SlateReplica(eng.dur.store, eng.wf, max_staleness_ticks=64)
        full.refresh(eng.dur.frontier)
        jfull = JReplica(j_kv.KVStore(eng.dur.cfg.store_root(),
                                      replicas=1, write_quorum=1,
                                      read_quorum=1), jwf,
                         max_staleness_ticks=64)
        jfull.refresh(tick=int(eng.dur.frontier.tick))
        assert inc.snapshot_tick == full.snapshot_tick
        assert inc.stats()["rows"] == full.stats()["rows"] == \
            jfull.stats()["rows"]
        for up in ("U1", "U2"):
            a = inc.read_many(up, keys, now=inc.snapshot_tick)
            b = full.read_many(up, keys, now=full.snapshot_tick)
            c = jfull.read_many(up, keys, now=full.snapshot_tick)
            for x, y, z in zip(a, b, c):
                _eq_slate(x, y)
                _eq_slate(y, z)
    assert 0 < inc.stats()["rows"]["U2"] < inc.stats()["rows"]["U1"]
    eng.close()


def test_replica_serves_http(tmp_path):
    eng = durable_engine(str(tmp_path / "d"), every_k=4)
    state, _ = eng.run(eng.init_state(), source(), 8)
    eng.checkpoint(state)
    rep = SlateReplica(eng.dur.store, eng.wf)
    rep.refresh(eng.dur.frontier)
    server = rep.serve()
    try:
        base = f"http://127.0.0.1:{server.port}"
        get = lambda p: json.loads(urllib.request.urlopen(base + p,
                                                          timeout=10).read())
        want = rep.read("U1", 3)
        assert get("/slate/U1/3") == {k: np.asarray(v).item()
                                      for k, v in want.items()}
        many = get("/slates/U1?keys=3,99999")["slates"]
        assert many["99999"] is None and many["3"] == get("/slate/U1/3")
        assert get("/status")["snapshot_tick"] == rep.snapshot_tick
    finally:
        server.close()
        eng.close()
