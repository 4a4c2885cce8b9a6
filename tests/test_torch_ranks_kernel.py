"""The multi-shard engine over a process group on the card: a one-rank
NCCL group (``launch.mesh.make_host_mesh`` on ``cuda``; the card
machine has one H100) against the same engine with no group on
``cuda``, bitwise — every hop through ``all_to_all_single``, every read
through ``all_gather``, the slate kernels per rank on local rows, and a
device-tier reconfigure over the group with the queues' backlog in
place.  The card cases skip without CUDA; the file imports no JAX and
nothing of the ``tests`` package (the card's machine has another
one)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.core.event import EventBatch
from repro_torch.core.operators import AssociativeUpdater, Mapper
from repro_torch.core.workflow import Workflow
from repro_torch.kernels.slate_lookup import kernel as lk
from repro_torch.kernels.slate_update import kernel as uk

SPEC = {"v": ((4,), torch.float32)}
S, B, TICKS = 8, 256, 12


@pytest.fixture
def group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.distributed as tdist
    from repro_torch.launch import mesh as tmesh
    tmesh.make_host_mesh(device="cuda")
    yield tdist.group.WORLD
    tmesh.close_world()


class Pass(Mapper):
    name = "M1"
    subscribes = ("S1",)
    in_value_spec = SPEC
    out_streams = {"S2": SPEC}

    def map_batch(self, b):
        return {"S2": EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid)}


class Sum(AssociativeUpdater):
    name = "U1"
    subscribes = ("S2",)
    in_value_spec = SPEC
    out_streams = {}
    table_capacity = 1 << 12
    sum_mergeable = True

    def slate_spec(self):
        return SPEC

    def lift(self, b):
        return {"v": b.value["v"]}

    def combine(self, a, b):
        return {"v": a["v"] + b["v"]}

    merge = combine


class Max(Sum):
    name = "U2"
    monoid = "max"

    def combine(self, a, b):
        return {"v": torch.maximum(a["v"], b["v"])}

    merge = combine


def feed(t, dev):
    rng = np.random.default_rng(100 + t)
    key = (rng.zipf(1.3, (S, B)) % 2000).astype(np.int32)
    v = rng.integers(0, 8, (S, B, 4)).astype(np.float32)
    on = lambda a: torch.from_numpy(a).to(dev)
    return {"S1": EventBatch(sid=on(np.zeros((S, B), np.int32)),
                             ts=on(np.full((S, B), t, np.int32)),
                             key=on(key), value={"v": on(v)},
                             valid=on(np.ones((S, B), bool)))}


def play(group, dev):
    eng = D.DistributedEngine(
        Workflow([Pass(), Sum(), Max()], external_streams=("S1",)),
        D.make_mesh((S,), ("data",), group=group),
        D.DistConfig(batch_size=1024, queue_capacity=4096, chunk_size=4,
                     exchange_slack=4.0), device=dev)
    uk.slate_update.launches = lk.slate_lookup.launches = 0
    c0 = dict(D.COLLECTIVES)
    st, _ = eng.run(eng.init_state(), lambda t, mx: feed(t, dev), TICKS)
    hops = D.COLLECTIVES["all_to_all_single"] - c0["all_to_all_single"]
    launches = (uk.slate_update.launches, lk.slate_lookup.launches)
    ran = convert.state_to_numpy(st)
    backlog = sum(int(q.size.sum()) for q in st["queues"].values())
    # the reconfigure with the queues' backlog in place: exchange_rows
    # and exchange_queue both run over the group
    st, r1 = eng.scale(st, 4, drain_max=0)
    st, r2 = eng.scale(st, 8, drain_max=0)
    scale_hops = D.COLLECTIVES["all_to_all_single"] - \
        c0["all_to_all_single"] - hops
    scaled = convert.state_to_numpy(st)
    st, drained = eng.drain(st)
    keys = np.arange(-2, 2010, dtype=np.int32)
    reads = [eng.read_slates(st, u, keys) for u in ("U1", "U2")]
    one = [eng.read_slate(st, u, 1) for u in ("U1", "U2")]
    return dict(state=ran, scaled=scaled, end=convert.state_to_numpy(st),
                stats=eng.stats(st), drained=drained, hops=hops,
                scale_hops=scale_hops, backlog=backlog, launches=launches,
                reads=reads, one=one, paths=[r1.path, r2.path],
                moved=[(r.moved_rows, r.moved_events) for r in (r1, r2)],
                n_ops=len(list(eng.wf.updaters())) + len(eng.wf.operators))


def _eq(a, b, path="x"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _eq(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_one_rank_nccl_engine_is_the_no_group_engine(group):
    dev = torch.device("cuda", torch.cuda.current_device())
    plain = play(None, dev)
    ranked = play(group, dev)
    assert plain["hops"] == plain["scale_hops"] == 0
    assert ranked["hops"] == 3 * TICKS
    # one for each updater's rows and each operator's queue, each scale
    assert ranked["scale_hops"] == 2 * ranked["n_ops"]
    assert ranked["launches"] == plain["launches"]
    assert ranked["launches"][0] == 2 * S * TICKS
    assert ranked["paths"] == ["device", "device"]
    rows, events = ranked["moved"][0]
    assert ranked["backlog"] and sum(rows.values()) and sum(events.values())
    for k in ("state", "scaled", "end", "stats", "drained", "reads", "one",
              "moved", "backlog"):
        _eq(plain[k], ranked[k], k)
