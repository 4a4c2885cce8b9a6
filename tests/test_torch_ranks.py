"""The multi-shard engine over the ranks of a gloo group on the CPU:
``DistributedEngine`` on 8 shards spread over 4 processes (2 a rank)
against the one-card port engine, bitwise.

The 4 ranks spawn once for the file (``tests/_ranks_worker.py engine``,
a ``FileStore`` under the module's temporary directory: no TCP port),
play every scenario of ``_ranks_worker.ENGINE`` and pickle whole-engine
views (each rank's block gathered); this process plays the same
scenarios on the one-card engine meanwhile, and the tests compare them:
fixed membership through ``step``, ``run_chunk`` and ``run`` (telemetry
on), a ``("pod", "data")`` (2, 4) grid, a small slack with drops (the
exchange order and ``exchange_dropped``), reads plain and of partials
(two-choice, a split hot key), ``stats``, ``fail_shard``, a durable
crash recovered on the ranks, with a log written on the ranks recovered
by one process and the reverse, and HTTP slate reads served by rank 0
through the read queue every rank drains at chunk boundaries.  The
fixed-membership scenario is also held to the JAX ``DistributedEngine``
(one 8-device subprocess, ``tests/_dist_ref.py ranks``), and the served
bodies to its ``StateHandle.serve``'s.  On a one-rank gloo group in this
process the collective counter shows every hop through
``all_to_all_single``, a read's one ``all_gather`` and a drain's
broadcasts; the read queue's packing, close and 503s."""
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist

from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.core.engine import StateHandle
from repro_torch.launch import mesh as tmesh
from tests import _dist_ref as ref
from tests import _ranks_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def spawn_ranks(group, d, world=WORLD):
    """Start the ranks of ``_ranks_worker.py`` for ``group`` under ``d``;
    returns the processes and the result path."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT])}
    out = os.path.join(d, "ranks.pkl")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_ranks_worker.py"),
         os.path.join(d, "store"), str(r), str(world), out, group,
         os.path.join(d, "ranks")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return procs, out


def collect(procs, out, timeout=400):
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def played(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    procs, out = spawn_ranks("engine", d)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]), "JAX_PLATFORMS": "cpu"}
    jout = os.path.join(d, "jax.pkl")
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_dist_ref.py"), jout,
         "ranks"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        one = W.play("engine", W.one_card, os.path.join(d, "one"))
        ranks = collect(procs, out)
        log = jax_proc.communicate(timeout=400)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, log[-6000:]
    with open(jout, "rb") as f:
        jax = pickle.load(f)
    return dict(one=one, ranks=ranks, jax=jax, dir=d)


def eq(a, b, path="result"):
    """Bitwise equality of nested results (numpy arrays, dicts, lists)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            eq(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            eq(x, y, f"{path}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, str):
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and np.array_equal(x, y), path


@pytest.mark.parametrize("name", [n for n in W.ENGINE
                                  if n not in ("durable", "serve")])
def test_ranks_equal_one_card(played, name):
    """Each scenario on 4 ranks equals the one-card engine bitwise:
    the gathered state (queues in their order, tables, counters, the
    sketch and histograms), stats, outputs, reads."""
    eq(played["one"][name], played["ranks"][name], name)


def test_scenarios_are_not_trivial(played):
    """The scenarios exercise what they claim: the small slack drops
    events at the exchange, two-choice and the split leave partials that
    reads merge, the fail-over loses the dead shard's rows."""
    one = played["one"]
    assert one["slack"]["stats"]["exchange_dropped"] > 0
    assert one["count"]["stats"]["processed"]["U2"] > 0
    assert one["split"]["split_set"] == [W.SPLIT["hot"]]
    hot = one["split"]["state"]["tables"]["U1"]["keys"] == W.SPLIT["hot"]
    assert hot.any(axis=1).sum() == 2           # both partials hold rows
    assert one["fail"]["failed"]["tables"]["U1"]["keys"][3].max() == -1
    assert one["run"]["n_outputs"] == W.RUN["ticks"]


def test_durable_crash_and_recovery_on_ranks(played):
    """A crash on 4 ranks recovered on 4 ranks equals the one-card crash
    recovered on one card: the frontier, the recovered state, the run to
    the end and its slates."""
    one, ranks = played["one"]["durable"], played["ranks"]["durable"]
    assert one["crash_frontier"] == ranks["crash_frontier"] > 0
    eq(one["own"], ranks["own"], "durable")


def test_one_process_log_recovered_on_ranks(played):
    """WALs, store and frontier written by one process, recovered on 4
    ranks, equal the one-card recovery."""
    eq(played["one"]["durable"]["own"], played["ranks"]["durable"]["cross"],
       "cross")


def test_ranks_log_recovered_on_one_process(played, tmp_path):
    """WALs written by 4 ranks (each its own shards'), the store and the
    frontier written by rank 0, recovered by one process, equal the
    one-card recovery."""
    src = os.path.join(played["dir"], "ranks", "durable", "cross_out")
    assert sorted(os.listdir(src)) == ["FRONTIER.json"] + [
        f"shard_{s:03d}" for s in range(W.SHARDS)] + ["store"]
    got = W.recover_run(W.one_card, src)
    eq(played["one"]["durable"]["own"], got, "recovered on one process")


def test_fixed_membership_matches_jax(played):
    """The 4-rank fixed-membership run against the JAX
    ``DistributedEngine`` on 8 host devices: state, stats, drain ticks,
    outputs and reads bitwise."""
    j, t = played["jax"]["count"], played["ranks"]["count"]
    eq(j["state"], t["state"], "state")
    assert j["stats"] == t["stats"] and j["drained"] == t["drained"]
    for o_j, o_t in zip(j["outputs"], t["outputs"]):
        assert set(o_j) == set(o_t) == {"S3"}
        eq(o_j["S3"], o_t["S3"], "outputs")
    for a, b in zip(j["reads"]["batched"], t["reads"]["batched"]):
        eq(a, b, "read_slates")
    for a, b in zip(j["reads"]["looped"], t["reads"]["looped"]):
        eq(a, b, "read_slate")


def test_ranks_made_collectives(played):
    """The 4-rank run went through the collectives: every hop's
    ``all_to_all_single``, the gathers of reads and stats."""
    c = played["ranks"]["collectives"]
    assert c["all_to_all_single"] > 0 and c["all_gather"] > 0
    assert c["gather_object"] > 0          # the flushes' rows, to rank 0
    assert c["all_gather_object"] > 0      # the frontiers' offsets


# ---- a one-rank gloo group in this process ----
@pytest.fixture
def world_of_one():
    tmesh.make_host_mesh(device="cpu")
    yield tdist.group.WORLD
    tmesh.close_world()


def test_one_rank_group_counts_every_hop(world_of_one):
    """Even a group of one is never bypassed: a tick of the counting
    workflow makes 3 hops (S1 -> M1, S2 -> U1, S2 -> U2), each one
    ``all_to_all_single``; a ``read_slates`` and a ``read_slate`` each
    gather once, ``stats`` once; and the run equals the no-group
    engine bitwise."""
    fs = ref.feeds(**W.COUNT)[:4]
    g = W._engine(W.count_ops(), W.SHARDS, ("data",), "S1", world_of_one,
                  dict(batch_size=64, queue_capacity=512))
    plain = W.one_card(W.count_ops(), batch_size=64, queue_capacity=512)
    assert g.world == 1 and g.n_local == W.SHARDS
    st, sp = g.init_state(), plain.init_state()
    for d in fs:
        before = dict(D.COLLECTIVES)
        st, _ = g.step(st, {"S1": W.tb(d)})
        assert D.COLLECTIVES["all_to_all_single"] - \
            before["all_to_all_single"] == 3
        assert D.COLLECTIVES["all_gather"] == before["all_gather"]
        sp, _ = plain.step(sp, {"S1": W.tb(d)})
    for call in (lambda: g.read_slates(st, "U1", W.READ_KEYS),
                 lambda: g.read_slate(st, "U1", 5),
                 lambda: g.stats(st)):
        before = dict(D.COLLECTIVES)
        call()
        assert {k: D.COLLECTIVES[k] - before[k] for k in before} == {
            "all_to_all_single": 0, "all_gather": 1,
            "all_gather_object": 0, "gather_object": 0, "broadcast": 0}
    before = dict(D.COLLECTIVES)
    sp, _ = plain.step(sp, {"S1": W.tb(fs[0])})
    plain.read_slates(sp, "U1", W.READ_KEYS)
    assert D.COLLECTIVES == before         # no group: no collective
    st, _ = g.step(st, {"S1": W.tb(fs[0])})
    eq(convert.state_to_numpy(sp), convert.state_to_numpy(st), "state")
    eq(W.reads(plain, sp, "U1"), W.reads(g, st, "U1"), "reads")


def test_exchange_over_a_group_of_one_is_the_local_exchange(world_of_one):
    """``exchange`` with a group returns the no-group layout bitwise (the
    reorder of what ``all_to_all_single`` delivers is the identity on
    one rank)."""
    ex = ref.exchange_inputs(**ref.EXCHANGE)
    b = W.tb(ex)
    b.sid.copy_(torch.from_numpy(ex["sid"]))
    dest = torch.from_numpy(ex["dest"])
    a, da = D.exchange(b, dest, 8, ref.EXCHANGE["cap"])
    c, dc = D.exchange(b, dest, 8, ref.EXCHANGE["cap"], world_of_one)
    eq(convert.to_plain(a), convert.to_plain(c), "received")
    eq(da.numpy(), dc.numpy(), "dropped")


def test_all_to_all_rows_reorders_source_major():
    """The received block ``[world_src, L_dst, L_src * cap]`` becomes
    ``[L_dst, n * cap]`` with global source 0's bucket first: checked on
    a stand-in for the collective that delivers what 4 ranks would."""
    world, L, cap = 4, 2, 3
    n = world * L
    # rank r's send buffer: row d holds, for each local source l, cap
    # cells tagged (global source, destination)
    send = [torch.tensor([[(r * L + l) * 100 + d for l in range(L)
                           for _ in range(cap)] for d in range(n)])
            for r in range(world)]

    class FakeGroup:
        pass

    def fake_a2a(out, buf, group=None):
        r = group.rank
        packed = [D._pack([s], n) for s in send]
        out.copy_(torch.cat([p[r * L:(r + 1) * L] for p in packed]))

    real = (D.dist.all_to_all_single, D.dist.get_world_size)
    D.dist.all_to_all_single = fake_a2a
    D.dist.get_world_size = lambda group=None: world
    try:
        for r in range(world):
            g = FakeGroup()
            g.rank = r
            got, = D.all_to_all_rows([send[r]], g)
            want = torch.tensor([[s * 100 + r * L + i for s in range(n)
                                  for _ in range(cap)] for i in range(L)])
            assert torch.equal(got, want), r
    finally:
        D.dist.all_to_all_single, D.dist.get_world_size = real


def test_shards_must_split_over_the_ranks():
    """A shard count the ranks cannot split raises (the JAX package's
    device check), at the mesh and at a grow (the elastic file's
    4-rank run shows the grow)."""
    with pytest.raises(ValueError, match="do not split evenly"):
        D._check_split(10, 4)
    D._check_split(8, 4)
    D._check_split(10, 1)               # a world of one takes any count


def test_serve_refused_across_ranks(played):
    """Over 4 ranks only rank 0 serves: the other ranks' ``serve``
    starts no server (``port`` None); their reads reach rank 0's answers
    through the drains."""
    ports = played["ranks"]["serve"]["ports"]
    assert isinstance(ports[0], int) and ports[0] > 0
    assert ports[1:] == [None] * (WORLD - 1)


def _count_of(body):
    return json.loads(body)["count"]


def test_served_reads_equal_one_card_at_their_tick(played):
    """Rank 0 of 4 serves ``COUNT``'s run over HTTP while it goes (a
    reader a path of ``_ranks_worker.SERVE_PATHS``): every answer
    carries the source tick of the chunk boundary whose drain served it
    and equals, status and body byte for byte, the one-card engine's
    answer at that tick; every path is answered at the first boundary;
    a key's count and the processed totals never fall; the state after
    the run is the one-card run's."""
    one, ranks = played["one"]["serve"], played["ranks"]["serve"]
    seen = {}
    for path, status, tick, body in ranks["live"]:
        t = int(tick)
        assert t in one["at_tick"], tick
        want = one["at_tick"][t][path]
        assert (status, body) == (want[0], want[2]), (path, t)
        assert want[1] is None         # one process reads directly
        seen.setdefault(path, []).append((t, body))
    assert set(seen) == set(W.SERVE_PATHS)
    for path, answers in seen.items():
        assert answers[0][0] == W.SERVE_CHUNK, path
        ticks = [t for t, _ in answers]
        assert ticks == sorted(ticks), path
        if path.startswith("/slate/") and answers[-1][1].startswith(b"{\"c"):
            counts = [_count_of(b) for _, b in answers
                      if b.startswith(b"{\"c")]
            assert counts == sorted(counts), path
        if path == "/status":
            done = [sum(json.loads(b)["processed"].values())
                    for _, b in answers]
            assert done == sorted(done)
    eq(one["state"], ranks["state"], "state")


def test_served_final_bodies_equal_jax(played):
    """One request a path queued after the run, answered by ``close()``'s
    last drain at the run's last tick: the ``/slate`` and ``/slates``
    bodies byte for byte the JAX package's ``StateHandle.serve`` bodies
    after the same 12 ticks (misses' 404s included), and every answer
    the one-card engine's."""
    one, ranks = played["one"]["serve"], played["ranks"]["serve"]
    jax = played["jax"]["count"]["served"]
    final = ranks["final"]
    assert set(final) == set(W.SERVE_PATHS)
    for path in ref.serve_paths():
        assert (final[path][0], final[path][2]) == (jax[path][0],
                                                    jax[path][2]), path
    assert {final[p][0] for p in ref.serve_paths()} == {200, 404}
    for path, (status, tick, body) in final.items():
        assert int(tick) == ref.COUNT["ticks"]
        assert (status, body) == (one["final"][path][0],
                                  one["final"][path][2]), path


# ---- the read queue, world-free or on a one-rank group ----
def test_packed_requests_round_trip():
    """A drain's broadcast buffer: kind, updater index, key count, keys;
    int64, so int64 keys pass whole."""
    from repro_torch.core import engine as E
    reqs = [("slate", "U2", [7]), ("status", None, []),
            ("slates", "U1", [1, -3, 2**40, 5]), ("metrics", None, []),
            ("slates", "U2", [])]
    words = E.pack_requests(reqs, ["U1", "U2"])
    assert words.dtype == np.int64
    assert words[:7].tolist() == [0, 1, 1, 7, 2, -1, 0]
    assert E.unpack_requests(words, ["U1", "U2"]) == reqs
    assert E.unpack_requests(E.pack_requests([], ["U1"]), ["U1"]) == []


def _ranked_handle(group, **kw):
    eng = W._engine(W.count_ops(), W.SHARDS, ("data",), "S1", group,
                    dict(batch_size=64, queue_capacity=512))
    st = eng.init_state()
    for d in ref.feeds(**W.COUNT)[:3]:
        st, _ = eng.step(st, {"S1": W.tb(d)})
    return eng, StateHandle(eng, st, **kw)


def _wait_queued(h, n):
    t0 = time.monotonic()
    while len(h._queue) < n:
        assert time.monotonic() - t0 < 30, "requests never queued"
        time.sleep(0.005)


def test_close_answers_pending_requests(world_of_one):
    """Reads made while no run goes wait on the queue; ``close()``'s last
    drain answers them in order, each equal to a direct read, with one
    ``all_gather`` a read and two broadcasts (the counts, the packed
    requests); an empty drain is one broadcast."""
    eng, h = _ranked_handle(world_of_one)
    srv = h.serve()
    before = dict(D.COLLECTIVES)
    assert h.drain() == 0
    assert D.COLLECTIVES["broadcast"] - before["broadcast"] == 1
    paths = ["/slate/U1/5", "/slates/U1?keys=1,2,99", "/status", "/metrics"]
    got = {}
    askers = [threading.Thread(target=lambda p=p: got.update(
        {p: ref.http_get(srv.port, p)})) for p in paths]
    for a in askers:
        a.start()
    _wait_queued(h, len(paths))
    assert not got                     # nothing answers before a drain
    before = dict(D.COLLECTIVES)
    h.close()
    for a in askers:
        a.join()
    made = {k: D.COLLECTIVES[k] - before[k] for k in before}
    assert made["broadcast"] == 2 and made["all_gather"] == len(paths)
    assert made["all_to_all_single"] == 0
    want = eng.read_slate(h.state, "U1", 5)
    assert json.loads(got["/slate/U1/5"][2]) == {
        k: v.item() for k, v in want.items()}
    assert json.loads(got["/status"][2]) == eng.stats(h.state)
    assert all(code == 200 for code, _, _ in got.values())
    assert got["/metrics"][2].startswith(b"# HELP")
    before = dict(D.COLLECTIVES)
    assert h.drain() == 0 and D.COLLECTIVES == before  # closed: no drain


def test_requests_after_close_or_past_timeout_get_503(world_of_one):
    """A request no drain takes within the handle's timeout answers 503
    (and leaves the queue: the next drain reads nothing); after
    ``close()`` a request answers 503 at once."""
    eng, h = _ranked_handle(world_of_one, timeout=0.3)
    srv = h.serve()
    code, tick, body = ref.http_get(srv.port, "/status")
    assert code == 503 and tick is None and b"no drain" in body
    assert h.drain() == 0              # the timed-out request is gone
    h.close()
    again = h.serve()                  # a server over the closed handle
    try:
        t0 = time.monotonic()
        code, _, body = ref.http_get(again.port, "/slate/U1/5")
        assert code == 503 and b"closed" in body
        assert time.monotonic() - t0 < 0.3
    finally:
        again.close()


def test_engine_without_group_never_queues():
    """Without a group (``DistributedEngine`` on one device) the server
    reads directly under ``read_lock``: nothing is queued, a drain is a
    no-op and no collective runs."""
    eng, h = _ranked_handle(None)
    srv = h.serve()
    try:
        before = dict(D.COLLECTIVES)
        code, tick, body = ref.http_get(srv.port, "/slate/U1/5")
        assert code == 200 and tick is None and not h._queue
        assert json.loads(body)["count"] == int(
            eng.read_slate(h.state, "U1", 5)["count"])
        assert h.drain() == 0 and D.COLLECTIVES == before
    finally:
        h.close()


def test_queue_loses_no_request_under_concurrent_readers(world_of_one):
    """32 reader threads (more than the cores), a drainer thread and a
    short switch interval: every request is answered once, in some
    drain, with the value of a direct read, and nothing is left queued."""
    eng, h = _ranked_handle(world_of_one)
    h.serve()                          # a handle that serves drains
    want = {k: None if r is None else int(r["count"]) for k, r in
            ((k, eng.read_slate(h.state, "U1", k)) for k in range(40))}
    got, errors, stop = [], [], threading.Event()

    def reader(i):
        try:
            for j in range(4):
                k = (7 * i + j) % 40
                r, _ = h._ask("slate", "U1", [k])
                got.append((k, None if r is None else int(r["count"])))
        except Exception as e:              # recorded and asserted on
            errors.append(e)

    def drainer():
        while not stop.is_set():
            h.drain()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(32)]
        d = threading.Thread(target=drainer)
        d.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        d.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not d.is_alive()
    assert not errors and not h._queue
    assert len(got) == 32 * 4 and all(want[k] == c for k, c in got)
    h.close()


def test_unserved_handle_never_drains(world_of_one):
    """A ranked handle that serves nothing (no rank called ``serve``)
    drains nothing: ``run`` with it and its ``close()`` make no
    broadcast, so an unserved run is the run without a handle."""
    eng, h = _ranked_handle(world_of_one)
    fs = ref.feeds(**W.COUNT)
    before = dict(D.COLLECTIVES)
    h.state, _ = eng.run(h.state, lambda t, mx: {"S1": W.tb(fs[t])}, 4,
                         start_tick=3, handle=h)
    h.close()
    assert D.COLLECTIVES["broadcast"] == before["broadcast"]


def test_key_outside_key_type_answers_400_and_the_run_goes_on(world_of_one):
    """A key the engine's key type cannot hold is refused before it is
    queued (400, ``/slate`` and ``/slates``); a request that does not
    pack (put on the queue past that check) fails alone, and the drain
    still broadcasts and answers the others; the run with the handle
    then goes on, its drains answering the next reads."""
    from concurrent.futures import Future
    from repro_torch.core.engine import _Request
    eng, h = _ranked_handle(world_of_one)
    srv = h.serve()
    half = 1 << (eng.key_bits - 1)
    for path in (f"/slate/U1/{half}", f"/slates/U1?keys=1,{-half - 1}"):
        code, tick, body = ref.http_get(srv.port, path)
        assert code == 400 and tick is None and b"outside int" in body, path
    assert not h._queue
    bad = _Request("slate", "U1", [2**64], Future())
    got = {}
    asker = threading.Thread(target=lambda: got.update(
        ok=ref.http_get(srv.port, "/slate/U1/5")))
    h._queue.append(bad)
    asker.start()
    _wait_queued(h, 2)
    before = dict(D.COLLECTIVES)
    assert h.drain() == 1
    asker.join()
    assert D.COLLECTIVES["broadcast"] - before["broadcast"] == 2
    assert isinstance(bad.future.exception(), OverflowError)
    assert got["ok"][0] == 200
    fs = ref.feeds(**W.COUNT)
    asker = threading.Thread(target=lambda: got.update(
        ok=ref.http_get(srv.port, "/slate/U1/5")))
    asker.start()
    _wait_queued(h, 1)
    h.state, _ = eng.run(h.state, lambda t, mx: {"S1": W.tb(fs[t])}, 4,
                         start_tick=3, handle=h)
    asker.join()
    assert got["ok"][0] == 200 and int(got["ok"][1]) == 7
    assert json.loads(got["ok"][2])["count"] == int(
        eng.read_slate(h.state, "U1", 5)["count"])
    h.close()
