"""The multi-shard engine on the card: ``DistributedEngine`` on ``cuda``
(every shard's slate updates, inserts and reads through the port's
kernels, the sketch and histograms through the count kernel) held
bitwise against itself on ``device="cpu"`` — counting on the fused sum
and max routes, a fail-over mid-run, a split hot key with telemetry on,
and a durable crash and recovery.  The card cases skip without CUDA;
the file imports no JAX, so it runs wherever the port does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.core.distributed import (DistConfig, DistributedEngine,
                                          make_mesh)
from repro_torch.core.durability import DurabilityConfig
from repro_torch.core.engine import stack_sources
from repro_torch.core.event import EventBatch
from repro_torch.core.operators import AssociativeUpdater, Mapper
from repro_torch.core.workflow import Workflow
from repro_torch.kernels.countmin import kernel as ck
from repro_torch.kernels.slate_lookup import kernel as lk
from repro_torch.kernels.slate_update import kernel as uk
from repro_torch.slates.flush import FlushConfig, FlushPolicy
from repro_torch.telemetry import TelemetryConfig

SPEC = {"v": ((4,), torch.float32)}
S = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


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


class Peak(Sum):
    name = "U2"
    sum_mergeable = False
    monoid = "max"

    def combine(self, a, b):
        return {"v": torch.maximum(a["v"], b["v"])}

    merge = combine


def source(device, per_shard=256, hot=None):
    def fn(t, _mx=None):
        rng = np.random.default_rng(300 + t)
        key = (rng.zipf(1.3, (S, per_shard)) % 900).astype(np.int32)
        if hot is not None:
            key[:, ::3] = hot
        v = rng.integers(0, 8, (S, per_shard, 4)).astype(np.float32)
        t_ = lambda a: torch.from_numpy(a).to(device)
        return {"S1": EventBatch(
            sid=t_(np.zeros((S, per_shard), np.int32)),
            ts=t_(np.full((S, per_shard), t, np.int32)), key=t_(key),
            value={"v": t_(v)}, valid=t_(np.ones((S, per_shard), bool)))}
    return fn


def engine(device, **cfg):
    wf = Workflow([Pass(), Sum(), Peak()], external_streams=("S1",))
    base = dict(batch_size=1024, queue_capacity=4096, exchange_slack=4.0)
    return DistributedEngine(wf, make_mesh((S,), ("data",)),
                             DistConfig(**{**base, **cfg}), device=device)


def same(a, b):
    pa, pb = convert.state_to_numpy(a), convert.state_to_numpy(b)

    def walk(x, y, path):
        if isinstance(x, dict):
            assert set(x) == set(y), path
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        else:
            assert np.array_equal(x, y), path
    walk(pa, pb, "state")


def drive(device, ticks=12, fail_at=None, split_at=None, hot=None, **cfg):
    eng = engine(device, **cfg)
    src = source(device, hot=hot)
    st = eng.init_state()
    for t in range(ticks):
        if t == fail_at:
            st = eng.fail_shard(st, 3)
        if t == split_at:
            st, _ = eng.split_keys(st, [hot])
        st, _ = eng.step(st, src(t))
    st, _ = eng.drain(st)
    return eng, st


def test_counting_on_card_bitwise(dev):
    uk.slate_update.launches = 0
    lk.slate_lookup.launches_by_route = dict.fromkeys(lk.ROUTES, 0)
    ecuda, scuda = drive(dev)
    assert uk.slate_update.launches > 0
    assert lk.slate_lookup.launches_by_route["find"] > 0
    ecpu, scpu = drive("cpu")
    same(scuda, scpu)
    assert ecuda.stats(scuda) == ecpu.stats(scpu)
    keys = list(range(-2, 60))
    for u in ("U1", "U2"):
        for a, b in zip(ecuda.read_slates(scuda, u, keys),
                        ecpu.read_slates(scpu, u, keys)):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a["v"], b["v"])


def test_run_chunk_on_card_equals_steps(dev):
    e1 = engine(dev)
    src = source(dev)
    per_tick = [src(t) for t in range(6)]
    stacked = stack_sources(per_tick)        # [T, S, B]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s1, _, info = e1.run_chunk(e1.init_state(), stacked)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tuple(info["throttle_hits"].shape) == (6, S)
    e2 = engine(dev)
    s2 = e2.init_state()
    for p in per_tick:
        s2, _ = e2.step(s2, p)
    same(s1, s2)


def test_fail_over_on_card_bitwise(dev):
    _, scuda = drive(dev, fail_at=6)
    _, scpu = drive("cpu", fail_at=6)
    same(scuda, scpu)
    assert int((scuda["tables"]["U1"].keys[3, :-1] != -1).sum()) == 0


def test_split_key_with_telemetry_on_card_bitwise(dev):
    ck.countmin_update.launches = 0
    kw = dict(hot=5, split_at=4, hot_key_capacity=8,
              telemetry=TelemetryConfig())
    ecuda, scuda = drive(dev, **kw)
    assert ck.countmin_update.launches > 0
    ecpu, scpu = drive("cpu", **kw)
    same(scuda, scpu)
    assert ecuda.split_key_set() == [5]
    a, b = ecuda.read_slate(scuda, "U1", 5), ecpu.read_slate(scpu, "U1", 5)
    assert torch.equal(a["v"], b["v"])


def test_durable_crash_and_recover_on_card(dev, tmp_path):
    """A durable run crashed after 9 ticks and recovered on the card
    equals the same on the CPU, and both write the same files."""
    def run(device, d):
        cfg = dict(durability=DurabilityConfig(
            dir=str(d), flush=FlushConfig(policy=FlushPolicy.EVERY_K,
                                          every_k=4)))
        eng = engine(device, **cfg)
        src = source(device)
        eng.run(eng.init_state(), src, 9)
        eng.close()
        eng = engine(device, **cfg)
        st = eng.recover()
        st, _ = eng.run(st, src, 3, start_tick=9)
        eng.close()
        return st

    scuda = run(dev, tmp_path / "cuda")
    scpu = run("cpu", tmp_path / "cpu")
    same(scuda, scpu)
    for sh in range(S):
        rel = f"shard_{sh:03d}/wal.log"
        assert (tmp_path / "cuda" / rel).read_bytes() == \
            (tmp_path / "cpu" / rel).read_bytes()
