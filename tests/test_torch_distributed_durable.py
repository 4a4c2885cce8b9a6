"""Port parity: per-shard durability of the multi-shard engine —
``run_durable``, a crash and ``recover`` — against the JAX
``DistributedEngine`` on the CPU, and the stream launcher at
``--shards 8``.

The JAX side runs once, in one module-scoped 8-device subprocess
(``tests/_dist_ref.py durable``), after the port has left its own crash
directory for it to recover.  Byte formats are equal, not just
readable: every file of a durable run (each shard's WAL, the store's
segments, the frontier) against the JAX run's.  Recovery crosses
packages both ways — the JAX run crashed after source tick 9 is recovered
by the port, the port's by the JAX engine — and every recovered state
is bitwise the JAX engine's recovery of the same files; with shard 3
failed before recovery its keys re-route and every slate still equals
the uninterrupted run's."""
import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.core.distributed import (DistConfig, DistributedEngine,
                                          make_mesh)
from repro_torch.core.durability import DurabilityConfig
from repro_torch.core.workflow import Workflow
from repro_torch.slates.flush import FlushConfig, FlushPolicy
from tests import _dist_ref as ref
from tests.test_torch_distributed import eq_read, eq_state, tb
from tests.test_torch_engine import (TCountingUpdater, TPassThroughMapper,
                                     _eq_tree)


def build(d, **cfg):
    dcfg = DistConfig(batch_size=64, queue_capacity=256,
                      durability=DurabilityConfig(
                          dir=str(d), flush=FlushConfig(
                              policy=FlushPolicy.EVERY_K,
                              every_k=ref.DURABLE_EVERY)), **cfg)
    wf = Workflow([TPassThroughMapper(), TCountingUpdater()],
                  external_streams=("S1",))
    return DistributedEngine(wf, make_mesh((8,), ("data",)), dcfg,
                             device="cpu")


def src(t):
    return {"S1": tb(ref.durable_feed(t))}


def crash(d):
    eng = build(d)
    _, _ = eng.run_durable(eng.init_state(), src, ref.DURABLE_CRASH)
    frontier = eng.dur.frontier.tick
    eng.close()                          # the state dies with the process
    return frontier


def recover_and_finish(d, fail=None):
    eng = build(d)
    if fail is not None:
        eng.ring.fail(fail)
    st = eng.recover()
    tick = int(st["tick"].max())
    # numpy views of a CPU state: copy before the run goes on
    recovered = copy.deepcopy(convert.state_to_numpy(st))
    # the source cursor resumes where the crashed run stopped feeding
    st, _ = eng.run_durable(st, src, ref.DURABLE_TICKS - ref.DURABLE_CRASH,
                            start_tick=ref.DURABLE_CRASH)
    slates = {k: eng.read_slate(st, "U1", k) for k in range(64)}
    stats = eng.stats(st)
    eng.close()
    return dict(state=st, tick=tick, recovered=recovered, slates=slates,
                stats=stats)


@pytest.fixture(scope="module")
def jdur(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("durable")
    port_crash = tmp / "port_crash"
    crash(port_crash)
    port_files = ref.dir_bytes(port_crash)   # before JAX recovers it
    res = ref.run_reference(tmp / "durable.pkl", "durable", tmp / "jax",
                            port_crash)
    return res, tmp / "jax", port_files


def same_recovery(got, want):
    assert got["tick"] == want["tick"]
    _eq_tree(want["recovered"], got["recovered"])
    eq_state(want["state"], got["state"])
    assert got["stats"] == want["stats"]
    for k in range(64):
        eq_read(want["slates"][k], got["slates"][k], k)


def test_run_durable_bitwise_with_equal_files(jdur, tmp_path):
    """The uninterrupted durable run: state, stats, the frontier and the
    source cursor equal, and every file — each shard's WAL, the store's
    segments, FRONTIER.json — byte for byte the JAX run's."""
    res, jdir, _ = jdur
    want = res["full"]
    eng = build(tmp_path / "full")
    st, nxt = eng.run_durable(eng.init_state(), src, ref.DURABLE_TICKS)
    assert nxt == want["next"] == eng.tick_cursor == ref.DURABLE_TICKS
    eq_state(want["state"], st)
    assert eng.stats(st) == want["stats"]
    f = eng.dur.frontier
    assert (f.tick, list(f.wal_offset), f.meta) == want["frontier"]
    assert int(st["tick"].max()) > ref.DURABLE_TICKS    # drain ticks
    for k in range(64):
        eq_read(want["slates"][k], eng.read_slate(st, "U1", k), k)
    eng.close()
    got, exp = ref.dir_bytes(tmp_path / "full"), ref.dir_bytes(jdir / "full")
    assert sorted(got) == sorted(exp)
    assert sum(p.endswith("wal.log") for p in got) == 8
    for p in exp:
        assert got[p] == exp[p], p


def test_crash_files_equal_and_self_recovery(jdur, tmp_path):
    """A crash after source tick 9 leaves the JAX run's files, byte for
    byte, and the port's recovery of its own crash equals the JAX
    engine's recovery of the same files, bitwise, through the 3 source
    ticks after it."""
    res, _, port_files = jdur
    assert crash(tmp_path / "c") == res["crash_frontier"]
    assert port_files == res["crash_files"]
    assert ref.dir_bytes(tmp_path / "c") == res["crash_files"]
    same_recovery(recover_and_finish(tmp_path / "c"), res["recover_port"])


def test_cross_recovery_jax_crash_to_port(jdur):
    """The port recovers the JAX engine's crash directory to the JAX
    engine's own recovery state."""
    res, jdir, _ = jdur
    same_recovery(recover_and_finish(jdir / "crash"), res["recover_port"])


def test_cross_recovery_port_crash_to_jax(jdur):
    """The JAX engine recovered the port's crash directory: resumed at
    the tick its frontier and log give, every slate equals the
    uninterrupted run's."""
    res, _, _ = jdur
    got = res["recover_port"]
    assert got["tick"] == res["crash_frontier"] + 2     # 2 replayed
    assert got["stats"]["queue_dropped"] == {"M1": 0, "U1": 0}
    for k in range(64):
        _eq_tree(res["full"]["slates"][k], got["slates"][k], k)


def test_recover_with_a_failed_shard(jdur, tmp_path):
    """Shard 3 never comes back (``tests/test_recovery.py::test_
    distributed_crash_recover_parity``): its flushed keys are restored
    and its WAL replayed onto the survivors by the current ring; every
    slate equals the uninterrupted JAX run's and shard 3 holds none."""
    res, _, _ = jdur
    crash(tmp_path / "f")
    got = recover_and_finish(tmp_path / "f", fail=3)
    for k in range(64):
        eq_read(res["full"]["slates"][k], got["slates"][k], k)
    keys = got["state"]["tables"]["U1"].keys[:, :-1]
    assert int((keys[3] != -1).sum()) == 0
    assert int((keys != -1).sum()) == sum(
        v is not None for v in got["slates"].values())
    assert got["tick"] == res["crash_frontier"] + 2     # 2 replayed


def test_durability_refuses_per_key_partials(tmp_path):
    with pytest.raises(ValueError, match="two_choice_threshold"):
        build(tmp_path, two_choice_threshold=4)


def _printed(out):
    lines = out.splitlines()
    i = lines.index("{")
    j = max(k for k, l in enumerate(lines) if l == "}")
    return json.loads("\n".join(lines[i:j + 1]))


def _store_rows(d):
    keys, _, s = DurabilityConfig(dir=str(d)).make_store().scan_rows("U1")
    return {int(k): (int(c), float(x))
            for k, c, x in zip(keys, s["count"], s["sum"])}


def test_launcher_shards_8_crash_and_recover_match_jax(jdur, tmp_path,
                                                       capsys):
    """``python -m repro_torch.launch.stream --shards 8``: uninterrupted,
    crashed at source tick 40 and recovered, the printed stats and the
    flushed stores equal the JAX launcher's at ``--shards 8``; the
    recovered run resumes at tick 40 and ends at the uninterrupted
    run's tick and slates."""
    from repro_torch.launch import stream
    res, jdir, _ = jdur
    jout = res["launcher"]
    outs = {}
    for run, more in (("full", []), ("crash", ["--crash-at", "40"]),
                      ("recover", ["--recover"])):
        d = tmp_path / ("full" if run == "full" else "crash")
        stream.main(["--device", "cpu", "--dir", str(d), "--shards", "8",
                     "--batch", "64",
                     *more])
        outs[run] = capsys.readouterr().out
    assert "CRASH at source tick 40" in outs["crash"]
    assert "resuming at source tick 40" in outs["recover"]
    for run in ("full", "recover"):
        assert _printed(outs[run]) == _printed(jout[run]), run
    assert _store_rows(tmp_path / "full") == _store_rows(jdir / "launch_full")
    assert _store_rows(tmp_path / "crash") == \
        _store_rows(jdir / "launch_crash")
    full, rec = _printed(outs["full"]), _printed(outs["recover"])
    assert full["tick"] == rec["tick"]
    assert _store_rows(tmp_path / "full") == _store_rows(tmp_path / "crash")
    assert [l for l in outs["full"].splitlines() if l.startswith("slate[")] \
        == [l for l in outs["recover"].splitlines()
            if l.startswith("slate[")]
