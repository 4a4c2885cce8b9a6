"""Port parity: live elasticity under durability — ``AutoscalePolicy``
through ``run`` with a per-shard WAL set that grows with the shards,
compaction that shrinks it, crashes recovered across packages both
ways — and the stream launcher's ``--scale-at`` / ``--rebalance-every``,
against the JAX ``DistributedEngine`` on the CPU.

The JAX side (``tests/_dist_ref.py elastic_durable``) runs once, in one
module-scoped 8-device subprocess, after the port has left its own run
directories for it to recover.  Held bitwise: the runs' states, stats,
reports (``pause_s`` aside), frontiers and every file of each run; each
package's recovery of the other's files equals the JAX engine's
recovery of its own, on the shard count the run ended with and on the
one it started with (the reference's
``test_autoscale_policy_through_run_and_durability`` and
``test_compaction_durable_recovery``)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.distributed import (AutoscalePolicy, DistConfig,
                                          DistributedEngine, make_mesh)
from repro_torch.core.durability import DurabilityConfig
from repro_torch.core.workflow import Workflow
from repro_torch.slates.flush import FlushConfig, FlushPolicy
from tests import _dist_ref as ref
from tests.test_torch_elasticity import (elastic_ops, eq_reads, host, reads,
                                         tbatch)
from tests.test_torch_engine import _eq_tree

A, C = ref.AUTOSCALE_DURABLE, ref.COMPACT_DURABLE


def build(d, n, every_k, ops="fwd", policy=None):
    cfg = DistConfig(batch_size=64 if ops == "fwd" else 32,
                     queue_capacity=512 if ops == "fwd" else 256,
                     fused="off" if ops == "U1" else "auto",
                     durability=DurabilityConfig(
                         dir=str(d), flush=FlushConfig(
                             policy=FlushPolicy.EVERY_K, every_k=every_k)),
                     autoscale=policy)
    return DistributedEngine(
        Workflow(elastic_ops(ops), external_streams=("S1",)),
        make_mesh((n,), ("data",)), cfg, device="cpu")


def auto_run(d):
    reports = []
    eng = build(d, A["shards"], A["every_k"], policy=AutoscalePolicy(
        scale_at=dict(A["scale_at"]), rebalance_every=A["rebalance_every"],
        on_change=reports.append))
    out, st = ref.durable_elastic_run(eng, tbatch, host, reports)
    out["slates"] = reads(eng, st, np.arange(64, dtype=np.int32))
    out["pause"] = [r.pause_s > 0 for r in reports]
    eng.close()
    return out


def compact_run(d):
    eng = build(d, C["shards"], C["every_k"], ops="U1")
    out, _ = ref.compact_durable_run(eng, tbatch, host)
    eng.close()
    return out


def recovered(d, n, every_k, ops="fwd"):
    eng = build(d, n, every_k, ops)
    st = eng.recover()
    st, _ = eng.drain(st)
    out = dict(state=host(st), stats=eng.stats(st),
               slates=reads(eng, st, np.arange(64, dtype=np.int32)))
    eng.close()
    return out


@pytest.fixture(scope="module")
def jed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_durable")
    port = {"auto": auto_run(tmp / "port_auto"),
            "compact": compact_run(tmp / "port_compact")}
    port["auto_files"] = ref.dir_bytes(tmp / "port_auto")
    port["compact_files"] = ref.dir_bytes(tmp / "port_compact")
    res = ref.run_reference(tmp / "elastic_durable.pkl", "elastic_durable",
                            tmp / "jax", tmp / "port_auto")
    return res, port, tmp / "jax"


def same_run(want, got):
    _eq_tree(want["state"], got["state"])
    assert got["stats"] == want["stats"]
    for k in want:
        if k not in ("state", "stats", "slates"):
            assert got[k] == want[k], k
    eq_reads(want["slates"], got["slates"])


def same_files(want, got):
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p] == want[p], p


def truth():
    t = np.zeros(64, np.int64)
    for tick in range(A["ticks"]):
        np.add.at(t, ref.autoscale_feed(tick)[0], 1)
    return t


def test_autoscale_run_matches_jax_with_equal_files(jed):
    """``AutoscalePolicy(scale_at={4: 8}, rebalance_every=3)`` through
    ``run`` with a flush every 4 engine ticks: the reports (a physical
    grow on the host tier, rebalances on the device tier), the state,
    the frontier, each shard's WAL ticks (no tick logged twice) and
    every file, against the JAX run; every slate is the feed's count."""
    res, port, _ = jed
    want = res["auto"]
    got = dict(port["auto"])
    assert all(got.pop("pause"))
    same_run(want, got)
    paths = [(r["path"], r["recompiled"]) for r in got["reports"]]
    assert ("host", True) in paths and got["n_shards"] == 8
    assert all(len(t) == len(set(t)) for t in got["wal_ticks"])
    counts = [0 if r is None else int(r["count"]) for r in got["slates"]]
    assert np.array_equal(np.asarray(counts[:32]), truth()[:32])
    same_files(res["auto_files"], port["auto_files"])


@pytest.mark.parametrize("n", [8, 4])
def test_autoscale_recovery_across_packages(jed, tmp_path, n):
    """A crash after the scaled run: the port recovers the JAX run's
    files on 8 shards (where the run ended) and on 4 (where it began:
    the extra shards' WAL suffixes fold into the replay), and the JAX
    engine the port's on 8 (the files are byte-equal, so that one run
    stands for both counts); every recovery equals the JAX engine's
    recovery of its own files, bitwise, with every slate the feed's
    count."""
    import shutil
    res, _, jdir = jed
    want = res[f"auto_recover_{n}"]
    d = tmp_path / "auto"
    shutil.copytree(jdir / "auto_for_port", d)
    got = recovered(d, n, A["every_k"])
    for other in (got, res.get(f"port_auto_recover_{n}", got)):
        _eq_tree(want["state"], other["state"])
        assert other["stats"] == want["stats"]
        eq_reads(want["slates"], other["slates"])
    counts = [0 if r is None else int(r["count"]) for r in got["slates"]]
    assert np.array_equal(np.asarray(counts[:32]), truth()[:32])


def test_compaction_durable_matches_jax_and_recovers(jed, tmp_path):
    """``test_compaction_durable_recovery``: 6 of 8 shards leave (a
    compaction to 2: the WAL set shrinks with the state), 2 more ticks,
    then a crash; the run and its files equal the JAX run's (so the JAX
    engine recovers the port's files as its own), and the port's
    recovery of the JAX files on 2 shards equals the JAX engine's,
    bitwise."""
    import shutil
    res, port, jdir = jed
    got = port["compact"]
    for k in ("report", "n_wals", "frontier", "stats"):
        assert got[k] == res["compact"][k], k
    _eq_tree(res["compact"]["mid"], got["mid"])
    _eq_tree(res["compact"]["state"], got["state"])
    assert got["report"]["recompiled"] and got["report"]["n_shards"] == 2
    assert got["n_wals"] == 2
    same_files(res["compact_files"], port["compact_files"])
    d = tmp_path / "compact"
    shutil.copytree(jdir / "compact_for_port", d)
    mine = recovered(d, 2, C["every_k"], ops="U1")
    want = res["compact_recover"]
    _eq_tree(want["state"], mine["state"])
    assert mine["stats"] == want["stats"]
    eq_reads(want["slates"], mine["slates"])


def _printed(out):
    lines = out.splitlines()
    i = lines.index("{")
    j = max(k for k, l in enumerate(lines) if l == "}")
    return (json.loads("\n".join(lines[i:j + 1])),
            [l for l in lines if l.startswith("reconfigured:")],
            [l for l in lines if l.startswith("slate[")])


def test_launcher_scale_at_matches_jax(jed, tmp_path, capsys):
    """``python -m repro_torch.launch.stream --shards 4 --scale-at 6:2
    --rebalance-every 4``: the reconfigure lines, the stats and the
    slates it prints equal the JAX launcher's."""
    from repro_torch.launch import stream
    res, _, _ = jed
    stream.main(["--device", "cpu", "--dir", str(tmp_path / "s"),
                 *ref.LAUNCH_SCALE])
    got = _printed(capsys.readouterr().out)
    want = _printed(res["launcher"])
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[1]) >= 3
    strip = lambda ls: [l.replace("array(", "").replace(
        ", dtype=int32)", "").replace(", dtype=float32)", "") for l in ls]
    assert strip(got[2]) == strip(want[2])
