"""Durability on the card: a small durable run crashed and recovered on
``cuda`` (slates bitwise equal to an uninterrupted run and to the same
run on the CPU, every ``insert_or_find`` walk on the lookup kernel's
``find`` route), and the ordering of the two copies that leave the
tick's stream: a flush snapshot's rows are the table as it stood at
``begin`` even while later ticks write it, and a WAL append's host copy
is the batch as it stood at ``append``.  The card cases skip without
CUDA; the file imports no JAX, so it runs wherever the port does.

The workflow and source helpers at the top are shared with
``tests/test_torch_durability.py`` and its crash subprocess."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.durability import DurabilityConfig, stage_sources
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.event import EventBatch
from repro_torch.core.operators import (AssociativeUpdater, Mapper,
                                        SequentialUpdater)
from repro_torch.core.workflow import Workflow
from repro_torch.slates import flush as flush_mod
from repro_torch.slates import table as tbl
from repro_torch.slates.flush import FlushConfig, FlushPolicy

VSPEC = {"x": ((), torch.int32)}
# int64 keys are offset past 2**32, so both halves of the key differ
KEY_OFFSET = {np.int32: 0, np.int64: 2**33 + 12345}


class Pass(Mapper):
    name = "M1"
    subscribes = ("S1",)
    in_value_spec = VSPEC
    out_streams = {"S2": VSPEC}

    def map_batch(self, batch):
        return {"S2": EventBatch(sid=batch.sid, ts=batch.ts + 1,
                                 key=batch.key, value=batch.value,
                                 valid=batch.valid)}


class Sum(AssociativeUpdater):
    """A counter on the fused slate-update path."""
    name = "U1"
    subscribes = ("S2",)
    in_value_spec = VSPEC
    out_streams = {}
    table_capacity = 512
    sum_mergeable = True

    def slate_spec(self):
        return {"count": ((), torch.int32), "sum": ((), torch.float32)}

    def lift(self, batch):
        return {"count": torch.ones_like(batch.key, dtype=torch.int32),
                "sum": batch.value["x"].to(torch.float32)}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"], "sum": a["sum"] + b["sum"]}

    merge = combine


class Last(SequentialUpdater):
    """Order-sensitive: the last value and a step count."""
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
        return new, {"S3": {"key": ev["key"], "value": {"x": new["n"]},
                            "emit": True}}


def feed(t, n_keys=40, n=24, seed=1000):
    """Tick t's numpy keys (int64, before the offset) and values."""
    rng = np.random.default_rng(seed + t)
    return rng.integers(0, n_keys, size=n), \
        rng.integers(0, 9, size=n).astype(np.int32)


def source(kd=np.int32, device="cpu", **kw):
    """``source_fn`` of :func:`feed` for the port, keys of dtype ``kd``."""
    def f(t, ingest=None):
        k, x = feed(t, **kw)
        return {"S1": EventBatch.of(np.asarray(k + KEY_OFFSET[kd], kd),
                                    {"x": x}, ts=t, device=device)}
    return f


def durable_engine(d, kd=np.int32, ops=None, device="cpu", every_k=8,
                   **dur_kw):
    wf = Workflow(ops or [Pass(), Sum()], external_streams=("S1",))
    dur_kw.setdefault("flush", FlushConfig(policy=FlushPolicy.EVERY_K,
                                           every_k=every_k))
    cfg = EngineConfig(batch_size=32, queue_capacity=128, chunk_size=4,
                       key_dtype=np.dtype(kd).name,
                       durability=DurabilityConfig(dir=d, **dur_kw))
    return Engine(wf, cfg, device=device)


def slates_of(state, name="U1"):
    """{key: (ts, leaf bytes...)} of every occupied slot below the sink
    row: slot-order independent (recovery re-inserts in key order)."""
    t = state["tables"][name]
    C = t.capacity
    keys = t.keys[:C].cpu().numpy()
    ts = t.ts[:C].cpu().numpy()
    leaves = [t.vals[k][:C].cpu().numpy() for k in sorted(t.vals)]
    return {int(k): (int(ts[i]),) + tuple(v[i].tobytes() for v in leaves)
            for i, k in enumerate(keys) if k != tbl.EMPTY}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("kd", [np.int32, np.int64])
def test_crash_and_recover_on_card(dev, tmp_path, kd):
    from repro_torch.kernels.slate_lookup import kernel as lk
    n_total, n_crash = 24, 12
    src = source(kd, device=dev)
    ea = durable_engine(str(tmp_path / "a"), kd, device=dev)
    sa, _ = ea.run(ea.init_state(), src, n_total)
    base, base_tick = slates_of(sa), int(sa["tick"])
    ea.close()
    ec = durable_engine(str(tmp_path / "cpu"), kd)
    sc, _ = ec.run(ec.init_state(), source(kd), n_total)
    assert slates_of(sc) == base          # the card equals the CPU
    ec.close()

    quorum = dict(replicas=3, write_quorum=2, read_quorum=2)
    eb = durable_engine(str(tmp_path / "b"), kd, device=dev, **quorum)
    sb, _ = eb.run(eb.init_state(), src, n_crash)
    assert eb.dur.frontier.tick > 0
    del sb                                 # the crash
    eb.close()

    e2 = durable_engine(str(tmp_path / "b"), kd, device=dev, **quorum)
    e2.dur.store.set_replica_down(0)       # recovery reads a quorum of 2
    find0 = lk.slate_lookup.launches_by_route["find"]
    s2 = e2.recover()
    assert lk.slate_lookup.launches_by_route["find"] > find0
    s2, _ = e2.run(s2, src, n_total - n_crash, source_offset=n_crash)
    assert int(s2["tick"]) == base_tick
    assert slates_of(s2) == base
    e2.close()


def test_snapshot_reads_the_table_as_of_begin(dev):
    """Ticks issued after ``begin`` write the table in place; the
    snapshot, resolved on its own stream after them, still holds the
    rows as they stood at ``begin`` (and only the dirty ones)."""
    C = 1 << 20
    t = tbl.make_table(C, {"v": ((8,), torch.float32)}, device=dev)
    keys = torch.arange(1000, 1000 + 5000, device=dev)
    t, slot, _, placed = tbl.insert_or_find(
        t, keys.to(torch.int32), torch.ones(5000, dtype=torch.bool,
                                            device=dev))
    assert bool(placed.all())
    vals = torch.arange(5000 * 8, dtype=torch.float32,
                        device=dev).reshape(5000, 8)
    tbl.write_slates(t, slot, placed, {"v": vals}, 7)
    token = flush_mod.begin_dirty_snapshot(t)
    assert not bool(t.dirty.any())       # cleared in place at begin
    # later ticks: a long run of in-place writes on the tick stream
    for i in range(200):
        t.vals["v"].add_(1.0)
        tbl.write_slates(t, slot, placed, {"v": vals * -1}, 8 + i)
    k, ts, v = flush_mod.finish_dirty_snapshot(token)
    order = np.argsort(k)
    assert np.array_equal(k[order], np.arange(1000, 6000))
    assert (ts == 7).all()
    assert np.array_equal(v["v"][order], vals.cpu().numpy())
    torch.cuda.synchronize()


def test_snapshot_skips_the_sink_row_on_card(dev):
    t = tbl.make_table(64, {"v": ((), torch.int32)}, device=dev)
    t.keys[64] = 99                      # a losing claimant's key
    t.dirty[64] = True
    t, slot, _, placed = tbl.insert_or_find(
        t, torch.tensor([5], dtype=torch.int32, device=dev),
        torch.ones(1, dtype=torch.bool, device=dev))
    tbl.write_slates(t, slot, placed,
                     {"v": torch.tensor([3], dtype=torch.int32,
                                        device=dev)}, 1)
    k, ts, v = flush_mod.finish_dirty_snapshot(
        flush_mod.begin_dirty_snapshot(t))
    assert k.tolist() == [5] and v["v"].tolist() == [3]


def test_append_copy_holds_the_batch_as_of_append(dev):
    """A WAL append's host copy is issued on the tick stream: a later
    in-place write of the source batch cannot reach it."""
    b = EventBatch.of(torch.arange(1 << 20, device=dev),
                      {"x": torch.ones(1 << 20, dtype=torch.int32,
                                       device=dev)}, ts=3)
    staged, event = stage_sources({"S1": b})
    for _ in range(50):
        b.value["x"].mul_(3)
        b.key.add_(1)
    event.synchronize()
    s = staged["S1"]
    assert s.key.is_pinned() and not s.key.is_cuda
    assert torch.equal(s.key, torch.arange(1 << 20))
    assert bool((s.value["x"] == 1).all())
