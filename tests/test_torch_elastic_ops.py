"""Port parity: planned leaves with events in flight, the rejoin, the
load-aware ``rebalance``, compaction's lifetime counters, growth of a
``("pod", "data")`` mesh and ``clear_split``, against the JAX
``DistributedEngine`` on the CPU.

The JAX side plays these ``tests/_dist_ref.py`` ``ELASTIC`` scenarios in
one module-scoped 8-device subprocess of its own (group ``elastic``;
``tests/test_torch_elasticity.py`` plays the others, so the two files
share the suite's workers); the port plays them here with
``device="cpu"`` and is held bitwise as there.  Also the reference
tests' own assertions, in the port: a leave with backlog stays on the
device tier and moves as many events as the host remap, leaving shards
hold no row, a hot shard sheds vnodes and a second rebalance is a
no-op, compaction keeps every lifetime counter, and ``clear_split``
leaves each split key whole on one shard."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import _dist_ref as ref
from tests.test_torch_elasticity import port_play, same_play, slate_counts

NAMES = ("leave_backlog_device", "leave_backlog_host", "inflight_rejoin",
         "rebalance_hot", "compact_fold", "multiaxis", "clear_split")


@pytest.fixture(scope="module")
def jel(tmp_path_factory):
    return ref.run_reference(tmp_path_factory.mktemp("elastic_ops")
                             / "elastic_ops.pkl", "elastic", *NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_scenario_matches_jax(jel, name):
    got = port_play(ref.ELASTIC[name])
    same_play(jel[name], got)
    if name == "multiaxis":
        (r,) = got["reports"]
        assert (r["path"], r["recompiled"], r["n_shards"]) == ("host", True, 8)
    if name == "clear_split":
        # the split keys' partials converged onto their owner shards
        (r,) = [r for r in got["reports"] if r is not None]
        assert r["path"] == "device"
        keys = got["state"]["tables"]["U1"]["keys"]
        assert int((keys == 7).sum()) == 1 and int((keys == 9).sum()) == 1


def test_leave_with_backlog_stays_on_the_device_tier():
    """``test_planned_leave_with_backlog_stays_on_device_path``: with
    ``drain_max=0`` and a backlog, the device tier re-homes the queued
    events (``exchange_queue``), moves as many as the host remap, drains
    no tick and reads every slate as the host tier."""
    dev = port_play(ref.ELASTIC["leave_backlog_device"])
    hst = port_play(ref.ELASTIC["leave_backlog_host"])
    (d,), (h,) = dev["reports"], hst["reports"]
    assert (d["path"], h["path"]) == ("device", "host")
    assert d["drain_ticks"] == 0 == h["drain_ticks"]
    assert sum(d["moved_events"].values()) > 0
    assert d["moved_events"] == h["moved_events"]
    assert slate_counts(dev["reads"]) == slate_counts(hst["reads"])
    assert dev["stats"]["queue_dropped"] == hst["stats"]["queue_dropped"]


def test_inflight_leave_is_loss_free_and_rejoins():
    """``test_remove_shards_loss_free_with_inflight_events``: the two
    most loaded shards leave with events queued; every event is counted
    once, the leavers hold no row, nothing is dropped, and the slots
    rejoin on the device tier without a grow."""
    spec = ref.ELASTIC["inflight_rejoin"]
    got = port_play(spec)
    leave, rejoin = got["reports"]
    assert sum(leave["moved_events"].values()) > 0
    gone = sorted(set(range(8)) - set(leave["active"]))
    assert len(gone) == 2
    keys = got["snaps"][0]["tables"]["U1"]["keys"]
    assert all(int((keys[s] != -1).sum()) == 0 for s in gone)
    truth = np.zeros(64, np.int64)
    for ks, _ in ref.elastic_feed(**spec["feed"]):
        np.add.at(truth, ks, 1)
    counts = [0 if r is None else int(r["count"]) for r in got["reads"]]
    assert np.array_equal(np.asarray(counts[2:66]), truth)
    assert got["stats"]["exchange_dropped"] == 0
    assert rejoin["path"] == "device" and not rejoin["recompiled"]
    assert rejoin["active"] == list(range(8))


def test_rebalance_sheds_the_hot_shard_and_rebases():
    """``test_rebalance_hot_ring_sheds_load`` and ``test_rebalance_
    window_rebase_back_to_back``: the shard that owns the one hot key
    loses vnodes and weight, the second rebalance sees an empty window
    and does nothing, and the hot key's count stays exact."""
    spec = ref.ELASTIC["rebalance_hot"]
    got = port_play(spec)
    first, second = got["reports"]
    assert first is not None and second is None
    assert got["vnodes"].min() < 64 < got["vnodes"].max()
    hot_owner = int(np.argmin(got["weights"]))
    assert got["weights"][hot_owner] < 1.0
    assert got["vnodes"][hot_owner] == got["vnodes"].min()
    assert int(got["reads"][7 + 2]["count"]) == 6 * 128


def test_compaction_keeps_lifetime_counters():
    """``test_compaction_folds_lifetime_counters``: after a leave and a
    forced compaction to 2 slots, ``processed``, every drop tally and
    the sketch's mass equal the uncompacted state's; a second
    ``compact`` is a no-op (``path`` ``"none"``) and a telemetry reading
    covers 2 shards."""
    got = port_play(ref.ELASTIC["compact_fold"])
    leave, comp, again = got["reports"]
    assert (comp["path"], comp["recompiled"], comp["n_shards"]) == \
        ("host", True, 2)
    assert (again["path"], again["recompiled"]) == ("none", False)
    before, after = got["snaps"][0], got["snaps"][1]

    def lifetime(p):
        out = {k: int(np.asarray(p[k]).sum()) for k in
               ("exchange_dropped", "throttle_hits", "deferred")}
        out["processed"] = int(sum(np.asarray(v).sum()
                                   for v in p["processed"].values()))
        out.update({f"sk_{k}": int(np.asarray(p["sketch"][k]).sum())
                    for k in ("total", "counts", "sample_n")})
        out["table_dropped"] = int(p["tables"]["U1"]["dropped"].sum())
        out["queue_dropped"] = int(p["queues"]["U1"]["dropped"].sum())
        return out

    assert lifetime(before) == lifetime(after)
    assert lifetime(before)["queue_dropped"] + \
        lifetime(before)["exchange_dropped"] > 0
    assert got["observe"]["n_shards"] == 2
