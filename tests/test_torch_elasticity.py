"""Port parity: live elasticity of the multi-shard engine (``scale``,
``remove_shards``, the device and host migration tiers, physical grow
and compaction) against the JAX ``DistributedEngine`` on the CPU.

The JAX side plays some of ``tests/_dist_ref.py``'s ``ELASTIC``
scenarios once, in one module-scoped 8-device subprocess (group
``elastic``; ``tests/test_torch_elastic_ops.py`` plays the others, so
the two files share the suite's workers); the port
plays the same scenarios here through the same player (``ref.play``)
with ``device="cpu"``.  Held bitwise: every ``MigrationReport``'s fields
but ``pause_s`` (a wall time; it must be positive), the state after each
reconfigure and at the end (queues, tables, counters, the sketch),
stats, reads and the ring.  Also the properties the reference's own
tests assert in one package (a scaled run equals a never-scaled one,
the tiers agree), and the differences by design: growing needs no
devices, and reads racing a ``scale`` see the state before or after it.
The reference's 8 -> 16 cases need 16 JAX devices: the port holds its
8 -> 16 runs against its own never-scaled run."""
import copy
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.core import distributed as dist
from repro_torch.core.distributed import (AutoscalePolicy, DistConfig,
                                          DistributedEngine, make_mesh)
from repro_torch.core.engine import StateHandle
from repro_torch.core.event import EventBatch as TBatch
from repro_torch.core.operators import AssociativeUpdater, Mapper
from repro_torch.core.workflow import Workflow
from repro_torch.telemetry import TelemetryConfig
from tests import _dist_ref as ref
from tests.test_torch_engine import _eq_tree

NAMES = ("scale_2to4", "device_tier", "host_tier", "grow_compact_grow")
VF = {"x": ((), torch.float32)}


class TECounter(AssociativeUpdater):
    """``tests/_dist_ref.py``'s ``ECounter``: count and f32 sum of x."""
    name = "U1"
    subscribes = ("S1",)
    in_value_spec = VF
    out_streams = {}
    table_capacity = 1024
    sum_mergeable = True

    def slate_spec(self):
        return {"count": ((), torch.int32), "sum": ((), torch.float32)}

    def lift(self, b):
        return {"count": torch.ones_like(b.key, dtype=torch.int32),
                "sum": b.value["x"]}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"], "sum": a["sum"] + b["sum"]}

    merge = combine


class TECounter2(TECounter):
    name = "U2"


class TEFwd(Mapper):
    name = "M1"
    subscribes = ("S1",)
    in_value_spec = VF
    out_streams = {"S2": VF}

    def map_batch(self, b):
        return {"S2": TBatch(sid=b.sid, ts=b.ts + 1, key=b.key,
                             value=b.value, valid=b.valid)}


class TECounterS2(TECounter):
    subscribes = ("S2",)


def elastic_ops(kind):
    return {"U1": lambda: [TECounter()],
            "U1U2": lambda: [TECounter(), TECounter2()],
            "fwd": lambda: [TEFwd(), TECounterS2()]}[kind]()


def tbatch(keys, xs, t, n, valid=None):
    """A ``[n, B / n]`` source batch of a global feed batch."""
    k = torch.from_numpy(np.ascontiguousarray(keys.reshape(n, -1)))
    v = np.ones(k.shape, bool) if valid is None else valid.reshape(n, -1)
    return TBatch(sid=torch.zeros(k.shape, dtype=torch.int32),
                  ts=torch.full(k.shape, t, dtype=torch.int32), key=k,
                  value={"x": torch.from_numpy(
                      np.ascontiguousarray(xs.reshape(n, -1)))},
                  valid=torch.from_numpy(np.ascontiguousarray(v)))


def host(st):
    # numpy views of a CPU state: copy before the run goes on
    return copy.deepcopy(convert.state_to_numpy(st))


def reads(eng, st, keys):
    return [None if r is None else {k: v.numpy() for k, v in r.items()}
            for r in eng.read_slates(st, "U1", keys)]


def elastic_engine(spec, **more):
    shards = spec["shards"]
    axes = spec.get("axes", ("data",))
    cfg = dict(spec["cfg"], **more)
    if "telemetry" in spec:
        cfg["telemetry"] = TelemetryConfig(**spec["telemetry"])
    return DistributedEngine(
        Workflow(elastic_ops(spec["ops"]), external_streams=("S1",)),
        make_mesh(shards if isinstance(shards, tuple) else (shards,), axes),
        DistConfig(axis_names=axes, **cfg), device="cpu")


def port_play(spec, **more):
    return ref.play(spec, elastic_engine(spec, **more), tbatch, host, reads)


def eq_reads(a, b, what="reads"):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert (x is None) == (y is None), f"{what} {i}"
        if x is not None:
            _eq_tree(x, y, f"{what} {i}")


def same_play(want, got):
    """Everything ``ref.play`` returns, bitwise."""
    assert got["reports"] == want["reports"]
    assert got["pause"] == want["pause"]
    assert len(got["snaps"]) == len(want["snaps"])
    for i, (a, b) in enumerate(zip(want["snaps"], got["snaps"])):
        _eq_tree(a, b, f"state after call {i}")
    _eq_tree(want["state"], got["state"])
    assert got["stats"] == want["stats"]
    assert got["drained"] == want["drained"]
    eq_reads(want["reads"], got["reads"])
    assert (got["n_shards"], got["active"]) == (want["n_shards"],
                                                want["active"])
    assert np.array_equal(got["vnodes"], want["vnodes"])
    assert np.array_equal(got["weights"], want["weights"])
    for k in ("heat_owners", "observe"):
        assert (k in got) == (k in want)
        if k in want:
            _eq_tree(want[k], got[k], k)


@pytest.fixture(scope="module")
def jel(tmp_path_factory):
    return ref.run_reference(tmp_path_factory.mktemp("elastic")
                             / "elastic.pkl", "elastic", *NAMES)


def slate_counts(rd):
    return [None if r is None else (int(r["count"]), r["sum"].tobytes())
            for r in rd]


@pytest.mark.parametrize("name", NAMES)
def test_scenario_matches_jax(jel, name):
    """Each scenario's reports, states, stats, reads and ring, bitwise
    against the JAX engine's."""
    spec = ref.ELASTIC[name]
    got = port_play(spec)
    same_play(jel[name], got)
    paths = [r["path"] for r in got["reports"] if r is not None]
    want = {"scale_2to4": ["host"], "device_tier": ["device", "device"],
            "host_tier": ["host", "host"],
            "grow_compact_grow": ["host", "host", "host"]}[name]
    assert paths == want
    if name == "grow_compact_grow":
        assert [r["n_shards"] for r in got["reports"]] == [4, 2, 4]
        assert all(r["recompiled"] for r in got["reports"])


def test_scaled_runs_equal_the_never_scaled_run():
    """The reference's own property (``test_scale_2to4_parity_fast``,
    ``test_device_migration_parity_fast``, ``test_grow_compact_grow_
    roundtrip_fast``): a run with reconfigures reads every slate
    bitwise as the run without them, on either tier."""
    for name, base in (("scale_2to4", None), ("device_tier", None),
                       ("grow_compact_grow", None)):
        spec = ref.ELASTIC[name]
        plain = dict(spec, at={})
        a = port_play(plain)
        b = port_play(spec)
        assert slate_counts(a["reads"]) == slate_counts(b["reads"]), name
    dev = port_play(ref.ELASTIC["device_tier"])
    hst = port_play(ref.ELASTIC["host_tier"])
    assert slate_counts(dev["reads"]) == slate_counts(hst["reads"])
    assert [r["moved_rows"] for r in dev["reports"]] == \
        [r["moved_rows"] for r in hst["reports"]]
    assert sum(r["bytes_moved"] for r in dev["reports"]) > 0


def _feed_16(seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 96, 128).astype(np.int32),
             rng.integers(0, 99, 128).astype(np.float32))
            for _ in range(12)]


def _run_16(start, scale_to=None, **cfg):
    eng = DistributedEngine(
        Workflow([TECounter()], external_streams=("S1",)),
        make_mesh((start,), ("data",)),
        DistConfig(batch_size=64, queue_capacity=512, **cfg), device="cpu")
    st = eng.init_state()
    if start == 16:
        st, rep0 = eng.remove_shards(st, list(range(8, 16)))
        assert not rep0.recompiled and rep0.path == (
            "host" if cfg.get("device_migration") == "off" else "device")
    rep = None
    for t, (keys, xs) in enumerate(_feed_16()):
        if scale_to and t == 6:
            st, rep = eng.scale(st, scale_to)
        st, _ = eng.step(st, {"S1": tbatch(keys, xs, t, eng.n_shards)})
    st, _ = eng.drain(st)
    return eng, st, rep


def test_scale_8_to_16_equals_never_scaled():
    """``test_live_scale_8to16_bitwise_parity`` and
    ``test_device_path_scale_8to16_bitwise_parity`` (16 JAX devices, so
    held in the port alone): a physical grow 8 -> 16 (host tier) and a
    rejoin 8 -> 16 of a 16-slot engine (device tier, and host with
    ``device_migration="off"``) read every slate as the never-scaled
    run, with no drop and rows on at least 4 of the new slots."""
    eng, st, _ = _run_16(8)
    want = slate_counts(reads(eng, st, np.arange(96)))
    for start, mode, path, grown in ((8, "auto", "host", True),
                                     (16, "auto", "device", False),
                                     (16, "off", "host", False)):
        eng, st, rep = _run_16(start, 16, device_migration=mode,
                               compact_threshold=0.0)
        assert rep.path == path and rep.recompiled == grown
        assert sum(rep.moved_rows.values()) > 0 and rep.bytes_moved > 0
        assert slate_counts(reads(eng, st, np.arange(96))) == want
        assert eng.stats(st)["exchange_dropped"] == 0
        occ = st["tables"]["U1"].occupancy().tolist()
        assert sum(1 for r in occ[8:] if r > 0) >= 4, occ


def test_growth_needs_no_devices_and_respects_the_trailing_axis():
    """A difference by design (ROADMAP queue 3): the JAX engine raises
    when a grow needs more devices than are visible; every shard of the
    port lives on the engine's one device, so 2 -> 64 grows.  Multi-axis
    meshes still grow and compact only in multiples of the leading
    axes' product, as in the reference."""
    eng = elastic_engine(ref.ELASTIC["scale_2to4"])
    st = eng.init_state()
    st, rep = eng.scale(st, 64)
    assert rep.recompiled and eng.n_shards == 64
    assert eng.mesh.shape == {"data": 64}
    assert st["tables"]["U1"].keys.shape[0] == 64
    assert eng.cap_per_dest == max(8, int(32 * 2.0 / 64))
    ma = elastic_engine(ref.ELASTIC["multiaxis"])
    with pytest.raises(ValueError, match="multiple"):
        ma._grow_physical(9)
    st = ma.init_state()
    st, _ = ma.remove_shards(st, [3], drain_max=0)
    with pytest.raises(ValueError, match="multiple"):
        ma.compact(st)


def test_reads_racing_a_scale_see_a_whole_state():
    """``test_concurrent_reads_during_live_scale``: readers on a
    ``StateHandle`` race ``run`` with a 4 -> 8 scale at tick 6; every
    read completes and sees a whole state, before or after the
    migration (no key's count ever goes back, as it would mid-way), and
    the run reads as a never-scaled one."""
    def src_of(eng):
        def src(t, _mx):
            rng = np.random.default_rng(40 + t)
            keys = rng.integers(0, 48, 128).astype(np.int32)
            xs = rng.integers(0, 99, 128).astype(np.float32)
            return {"S1": tbatch(keys, xs, t, eng.n_shards)}
        return src

    def build(pol):
        return DistributedEngine(
            Workflow([TECounter()], external_streams=("S1",)),
            make_mesh((4,), ("data",)),
            DistConfig(batch_size=32, queue_capacity=512, fused="off",
                       chunk_size=1, autoscale=pol), device="cpu")

    eng = build(AutoscalePolicy(scale_at={6: 8}))
    h = StateHandle(eng, eng.init_state())
    errors, n_reads = [], [0]
    stop = threading.Event()

    def reader():
        # counts only grow as the run goes on: a read of a half-migrated
        # table (a key between its old and new shard) would go back
        rng = np.random.default_rng(99)
        seen = np.zeros(48, np.int64)
        while not stop.is_set():
            try:
                k = int(rng.integers(0, 48))
                s = h.read_slate("U1", k)
                c = 0 if s is None else int(s["count"])
                assert c >= seen[k], (k, c, seen[k])
                seen[k] = c
                keys = rng.integers(0, 48, 16)
                got = h.read_slates("U1", keys.tolist())
                assert len(got) == 16
                for k, r in zip(keys, got):
                    c = 0 if r is None else int(r["count"])
                    assert c >= seen[k], (int(k), c, seen[k])
                    seen[k] = c
                n_reads[0] += 1
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for th in threads:
        th.start()
    st, _ = eng.run(h.state, src_of(eng), 12, handle=h)
    with eng.read_lock:
        st, _ = eng.drain(st)
        h.state = st
    stop.set()
    for th in threads:
        th.join(timeout=60)
    assert not errors, errors
    assert n_reads[0] > 0 and eng.n_shards == 8
    scaled = slate_counts(reads(eng, st, np.arange(48)))
    eng2 = build(None)
    st2, _ = eng2.run(eng2.init_state(), src_of(eng2), 12)
    st2, _ = eng2.drain(st2)
    assert scaled == slate_counts(reads(eng2, st2, np.arange(48)))


@pytest.mark.parametrize("length", [1, 2, 3, 4, 5, 7, 8, 13, 32, 37])
def test_associative_scan_matches_jax(length):
    """``exchange_rows`` folds a key's rows with the port of
    ``jax.lax.associative_scan``: the same combine tree, so a fold of
    three or more f32 partials (a key left on several shards by
    fail-overs under two-choice) rounds as the JAX package's.  Here the
    segmented fold over order-sensitive floats, bitwise."""
    rng = np.random.default_rng(length)
    S = 3
    flags = rng.random((S, length)) < 0.3
    flags[:, 0] = True
    vals = (rng.standard_normal((S, length)) * 10.0 ** rng.integers(
        -3, 8, (S, length))).astype(np.float32)
    ts = rng.integers(0, 50, (S, length)).astype(np.int32)

    def jfold(a, b):
        fa, va, ta = a
        fb, vb, tb = b
        return (fa | fb, jnp.where(fb, vb, va + vb),
                jnp.where(fb, tb, jnp.maximum(ta, tb)))

    want = jax.lax.associative_scan(
        jfold, (jnp.asarray(flags), jnp.asarray(vals), jnp.asarray(ts)),
        axis=1)

    def tfold(a, b):
        fa, va, ta = a
        fb, vb, tb = b
        return [fa | fb, torch.where(fb, vb, va + vb),
                torch.where(fb, tb, torch.maximum(ta, tb))]

    got = dist.associative_scan(tfold, [torch.from_numpy(flags),
                                        torch.from_numpy(vals),
                                        torch.from_numpy(ts)])
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()
