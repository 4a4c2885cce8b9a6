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
(two-choice, a split hot key), ``stats``, ``fail_shard``, and a durable
crash recovered on the ranks, with a log written on the ranks recovered
by one process and the reverse.  The fixed-membership scenario is also
held to the JAX ``DistributedEngine`` (one 8-device subprocess,
``tests/_dist_ref.py ranks``).  On a one-rank gloo group in this process
the collective counter shows every hop through ``all_to_all_single``
and a read's one ``all_gather``."""
import os
import pickle
import subprocess
import sys

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


@pytest.mark.parametrize("name", [n for n in W.ENGINE if n != "durable"])
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


def test_serve_refused_across_ranks():
    """The HTTP slate server never serves an engine over more than one
    rank (its reads are collectives); it names the ROADMAP item."""
    class Ranked:
        world = 4
        read_lock = None

    with pytest.raises(RuntimeError, match="15e"):
        StateHandle(Ranked()).serve()
