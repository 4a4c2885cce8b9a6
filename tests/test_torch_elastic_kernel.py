"""Live elasticity on the card: the device tier's ``exchange_rows`` and
``exchange_queue`` over the stacked state of 8 shards, and whole runs
that leave, rejoin, grow and compact, on ``cuda`` held bitwise against
the same on ``device="cpu"``; every table rebuild inserts through
``slate_lookup``'s ``find`` route (both tiers).  The card cases skip
without CUDA; the file imports no JAX, so it runs wherever the port
does."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distributed as dist
from repro_torch.kernels.slate_lookup import kernel as lk
from repro_torch.slates.table import INSERT_ROUNDS

# the workflow and feed of the fixed-membership card tests, loaded from
# their file (the card's machine has another package named ``tests``)
_spec = importlib.util.spec_from_file_location(
    "_distributed_kernel", Path(__file__).with_name(
        "test_torch_distributed_kernel.py"))
_dk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_dk)
S, engine, same, source = _dk.S, _dk.engine, _dk.same, _dk.source


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def backlog_state(device):
    """8 shards after 6 ticks with two-choice partials (a hot key over
    its threshold) and queued events (small batches)."""
    eng = engine(device, batch_size=256, queue_capacity=4096,
                 two_choice_threshold=16)
    src = source(device, hot=5)
    st = eng.init_state()
    for t in range(6):
        st, _ = eng.step(st, src(t))
    return eng, st


def test_exchanges_on_card_equal_cpu(dev):
    """Both exchanges under a reweighted ring with two shards out: the
    rebuilt tables (folded partials included), the re-homed queues, the
    drops and the movers equal the CPU's, bitwise."""
    out = {}
    for d in (dev, torch.device("cpu")):
        eng, st = backlog_state(d)
        ring = eng.ring
        ring.fail(2), ring.fail(6)
        ring.set_weights(np.array([1.0, 2.0, 1.0, 0.5, 1.0, 1.0, 1.0, 3.0]))
        rh, rs = ring.table(d)
        t, mr = dist.exchange_rows(st["tables"]["U1"], dist._salt("U1"),
                                   rh, rs, S, 4096, eng.wf.by_name[
                                       "U1"].combine)
        q, mq = dist.exchange_queue(st["queues"]["U1"], dist._salt("U1"),
                                    rh, rs, S, 1024)
        # a partial distributed state (it carries exchange_dropped, so
        # the comparison strips each shard's sink row)
        out[d.type] = (dict(queues={"U1": q}, tables={"U1": t},
                            exchange_dropped=mr), mr.cpu(), mq.cpu())
    (a, ra, qa), (b, rb, qb) = out["cuda"], out["cpu"]
    assert torch.equal(ra, rb) and torch.equal(qa, qb)
    assert int(ra.sum()) > 0 and int(qa.sum()) > 0
    same(a, b)
    keys = a["tables"]["U1"].keys[:, :-1]
    assert int((keys == 5).sum()) == 1          # the partials folded


def elastic_run(device, mode="auto"):
    """12 ticks: shards 6 and 7 leave with events queued at tick 3, all
    rejoin at 6, a physical grow to 12 at 8, then a leave to 3 active
    that compacts."""
    eng = engine(device, batch_size=512, exchange_slack=16.0,
                 device_migration=mode)
    src = source(device)
    st = eng.init_state()
    reports = []
    for t in range(12):
        if t == 3:
            st, r = eng.remove_shards(st, [6, 7], drain_max=0)
            reports.append(r)
        if t == 6:
            st, r = eng.scale(st, 8)
            reports.append(r)
        if t == 8:
            st, r = eng.scale(st, 12)
            reports.append(r)
        n = eng.n_shards
        b = src(t)["S1"]
        # the same global events, spread over the live shard count
        flat = {f: getattr(b, f).reshape((S * b.key.shape[1],)
                                         + tuple(getattr(b, f).shape[2:]))
                for f in ("sid", "ts", "key", "valid")}
        flat["value"] = {"v": b.value["v"].reshape(-1, 4)}
        pad = (-flat["key"].shape[0]) % n
        from repro_torch.core.event import EventBatch, tree_map
        eb = EventBatch(flat["sid"], flat["ts"], flat["key"], flat["value"],
                        flat["valid"]).pad_to(flat["key"].shape[0] + pad)
        st, _ = eng.step(st, {"S1": tree_map(
            lambda a: a.reshape((n, -1) + tuple(a.shape[1:])), eb)})
    st, r = eng.remove_shards(st, list(range(3, 12)))
    reports.append(r)
    st, _ = eng.drain(st)
    return eng, st, reports


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_elastic_run_on_card_equals_cpu(dev, mode):
    """The leave, rejoin, grow and compaction on the card: every report
    (``pause_s`` aside), the state and the stats equal the CPU run's."""
    lk.slate_lookup.launches_by_route = dict.fromkeys(lk.ROUTES, 0)
    ecuda, scuda, rcuda = elastic_run(dev, mode)
    assert lk.slate_lookup.launches_by_route["find"] > 0
    ecpu, scpu, rcpu = elastic_run("cpu", mode)
    fields = lambda r: {k: v for k, v in vars(r).items() if k != "pause_s"}
    assert [fields(r) for r in rcuda] == [fields(r) for r in rcpu]
    want = ["device", "device", "host", "host"] if mode == "auto" \
        else ["host"] * 4
    assert [r.path for r in rcuda] == want
    assert (ecuda.n_shards, ecuda.active_shards) == (3, [0, 1, 2])
    same(scuda, scpu)
    assert ecuda.stats(scuda) == ecpu.stats(scpu)


@pytest.mark.parametrize("tier", ["device", "host"])
def test_rebuilds_insert_through_the_find_route(dev, tier):
    """A device-tier leave rebuilds every shard's table with one
    ``insert_or_find`` (``INSERT_ROUNDS`` ``find`` launches an updater a
    shard); a host-tier one inserts in chunks of 256 rows on the card,
    also through ``find``; neither walks ``cand`` or ``keys``."""
    eng, st = backlog_state(dev)
    if tier == "host":
        eng.cfg.device_migration = "off"
    st, _ = eng.drain(st)
    lk.slate_lookup.launches_by_route = dict.fromkeys(lk.ROUTES, 0)
    st, rep = eng.remove_shards(st, [7])
    got = dict(lk.slate_lookup.launches_by_route)
    assert rep.path == tier
    assert got["cand"] == 0 == got["keys"]
    if tier == "device":
        assert got["find"] == INSERT_ROUNDS * S * 2
    else:
        rows = int(st["tables"]["U1"].occupancy().sum()) + int(
            st["tables"]["U2"].occupancy().sum())
        assert got["find"] >= INSERT_ROUNDS * -(-rows // 256)
