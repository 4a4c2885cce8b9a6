"""Live elasticity of the multi-shard engine over the ranks of a gloo
group on the CPU, bitwise against the one-card port engine, and the
stream launcher over 4 gloo ranks.

The 4 ranks spawn once for the file (``tests/_ranks_worker.py
elastic``, a ``FileStore`` under the module's temporary directory) and
play ``_ranks_worker.ELASTIC`` on 8 shards; this process plays the same
scenarios on the one-card engine meanwhile.  Device tier (shapes kept;
the rows and queued events move through ``all_to_all_single``, the plan
from one ``all_gather``): ``scale`` 8 -> 4 (a leave with backlog) -> 8,
``rebalance`` by load and by weights, a split then ``clear_split``.
Host tier (every rank remaps the gathered state, keeps its new block):
a grow 8 -> 16, a leave and ``compact`` back to 8; a grow to 10 on 4
ranks raises (one card takes it).  ``run`` under an ``AutoscalePolicy``
and under a ``LoadAutoscaler`` (its decisions from the gathered
telemetry, rank 0's broadcast).  A durable run across a grow and a
leave, crashed on 16 slots and recovered on 8.  The launcher serves
slates from rank 0 (``--serve``)."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import _dist_ref as ref
from tests import _ranks_worker as W
from tests.test_torch_ranks import collect, eq, spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def played(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks_elastic"))
    procs, out = spawn_ranks("elastic", d)
    try:
        one = W.play("elastic", W.one_card, os.path.join(d, "one"))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return dict(one=one, ranks=collect(procs, out))


@pytest.mark.parametrize("name", list(W.ELASTIC))
def test_reconfigures_on_ranks_equal_one_card(played, name):
    """Each reconfigure scenario on 4 ranks equals the one-card engine
    bitwise: the reports (path, rows and events moved, bytes), the state
    after each step, stats and reads."""
    one, ranks = dict(played["one"][name]), dict(played["ranks"][name])
    if name == "host_tier":
        one.pop("grow_10")
        ranks.pop("grow_10")
    eq(one, ranks, name)


def test_tiers_and_moves(played):
    """The device tier moved rows and queued events without a shape
    change; the host tier grew and compacted."""
    one = played["one"]
    down, up = one["scale"]["reports"]
    assert (down["path"], up["path"]) == ("device", "device")
    assert sum(down["moved_rows"].values()) > 0
    assert sum(down["moved_events"].values()) > 0       # the backlog
    assert one["scale"]["mid"]["active"] == [0, 1, 2, 3]
    assert [r["path"] for r in one["rebalance"]["reports"]
            if r is not None] == ["device"] * 2
    assert one["clear_split"]["report"]["path"] == "device"
    grow, leave, comp = one["host_tier"]["reports"]
    assert (grow["path"], grow["n_shards"]) == ("host", 16)
    assert (comp["path"], comp["n_shards"]) == ("host", 8)
    assert leave["path"] == "device"
    # the declared schedule fired its leave, rejoin and rebalances
    assert [len(r["active"]) for r in one["policy"]["reports"]] == \
        [4, 4, 8, 8]
    # the closed loop grew to 8 (host tier) and shrank back (device
    # tier) with the square wave, twice
    loop = one["closed_loop"]
    assert [(r["path"], len(r["active"])) for r in loop["reports"]] == [
        ("host", 8), ("device", 4), ("device", 8), ("device", 4)]
    assert max(loop["trace"]) == 8 and loop["trace"][-1] == 4
    # the durable run crashed on 16 slots and recovered on 8, every
    # event counted once
    dur = one["durable_scale"]
    assert dur["crashed"]["n_shards"] == 16 and \
        dur["end"]["n_shards"] == 8
    tally = np.zeros(64, np.int64)
    for keys, _ in ref.elastic_feed(seed=8, ticks=12, n=128, key_hi=64):
        np.add.at(tally, keys, 1)
    got = dict(zip(ref.ELASTIC_KEYS.tolist(),
                   dur["end"]["reads"]["batched"]))
    assert [0 if got[k] is None else int(got[k]["count"])
            for k in range(64)] == tally.tolist()


def test_grow_the_ranks_cannot_split_raises(played):
    """A grow to 10 shards raises on 4 ranks, naming the split; one card
    (a world of one) takes any count."""
    assert played["one"]["host_tier"]["grow_10"] == "ran"
    assert "do not split evenly over 4 ranks" in \
        played["ranks"]["host_tier"]["grow_10"]


def test_launcher_over_four_gloo_ranks(tmp_path):
    """``torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.stream --device cpu --shards 8 --serve``: rank 0
    serves and prints what the one-process ``--serve`` run prints (its
    URL, with the port masked, the stats and the slates), the other
    ranks nothing; every rank reaches the last drain through
    ``app.close()``, or the run would not end."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    args = ["-m", "repro_torch.launch.stream", "--ticks", "16", "--batch",
            "64", "--shards", "8", "--device", "cpu", "--flush-every", "8",
            "--serve"]
    one = subprocess.run([sys.executable, *args, "--dir",
                          str(tmp_path / "one")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-4000:]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4"]
    ranks = subprocess.run(run + args + ["--dir", str(tmp_path / "ranks")],
                           env=env, capture_output=True, text=True,
                           timeout=300)
    assert ranks.returncode == 0, ranks.stderr[-4000:]
    mask = lambda out: re.sub(r"127\.0\.0\.1:\d+/", "127.0.0.1:PORT/", out)
    assert mask(ranks.stdout) == mask(one.stdout)
    assert mask(one.stdout).count(
        "slates live at http://127.0.0.1:PORT/slate/U1/<k>\n") == 1
    stats = json.loads(one.stdout[one.stdout.index("{"):
                                  one.stdout.index("slate[")])
    assert stats["processed"]["U1"] > 0
