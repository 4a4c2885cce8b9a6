"""The count kernel (``csrc/countmin.cu``) against its plain version on
the card, bitwise, through both wrappers (``kernels/countmin`` and
``kernels/histogram``) and their fused routes: keys hashed in the kernel
against ``countmin_update(columns(...))``, ages bucketed in the kernel
against ``histogram_update(bucketize(...))``.  Every case needs a CUDA
card and skips without one; the file imports no JAX, so it runs wherever
the port does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.countmin import ref as t_cm_ref
from repro_torch.kernels.histogram import ref as t_hist_ref
from repro_torch.telemetry.sketch import make_salts

I32 = (-2**31, 2**31 - 1)
I64 = (-2**63, 2**63 - 1)


def _edge_ages():
    """0, 2**k - 1, 2**k, 2**k + 1 up to int32 max, and negative ages."""
    vals = [0, 1]
    for k in range(1, 31):
        vals += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    return [v for v in vals if v <= I32[1]] + [I32[1], -1, -5, I32[0] + 1]


@pytest.mark.parametrize("depth,width,B", [
    (2, 2048, 65536),     # the engine's default sketch at the chip shape
    (3, 1000, 5000),      # a width no multiple of 128
    (4, 8192, 20000),     # 128 KB: above the shared-memory path
    (1, 128, 70000),      # one histogram row
])
def test_kernel_matches_ref_on_card(depth, width, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.countmin import kernel as k
    from repro_torch.kernels.histogram import kernel as hk
    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    # a Zipf head: most events on a few columns
    p = np.arange(1, width + 1, dtype=np.float64) ** -1.2
    cols = rng.choice(width, size=(depth, B), p=p / p.sum()).astype(np.int32)
    add = (rng.random(B) < 0.9).astype(np.int32)
    counts = rng.integers(0, 50, (depth, width)).astype(np.int32)
    c = torch.from_numpy(cols).to(dev)
    a = torch.from_numpy(add).to(dev)
    want = t_cm_ref.countmin_update(torch.from_numpy(counts).to(dev), c, a)
    got = k.countmin_update(torch.from_numpy(counts).to(dev), c, a)
    hgot = hk.histogram_update(torch.from_numpy(counts).to(dev), c, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(hgot, want)


def _keys(rng, B, dtype):
    """Zipf keys spread over the key type, with its extremes."""
    p = np.arange(1, 5001, dtype=np.float64) ** -1.2
    ids = rng.choice(5000, size=B, p=p / p.sum())
    if dtype == np.int64:     # negative keys and keys above 2**32
        keys = (ids.astype(np.int64) - 2500) * (2**33 + 12345)
        edges = [I64[0], I64[1], -1, 0, 2**32, 2**32 - 1, -2**32]
    else:
        keys = (ids.astype(np.int64) * 858_993 - 2**31).astype(np.int32)
        edges = [I32[0], I32[1], -1, 0]
    keys[:len(edges)] = edges
    return keys.astype(dtype)


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("depth,width,B", [
    (2, 2048, 65536),     # the engine's default sketch at the chip shape
    (3, 1000, 5000),      # a width no multiple of 128
    (8, 8192, 20000),     # the deepest sketch, above the shared-memory path
    (1, 1, 100),
])
def test_keys_route_matches_plain_composition_on_card(key_dtype, depth,
                                                      width, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.countmin import kernel as k
    rng = np.random.default_rng(depth)
    dev = torch.device("cuda")
    keys = torch.from_numpy(_keys(rng, B, key_dtype)).to(dev)
    add = torch.from_numpy((rng.random(B) < 0.9).astype(np.int32)).to(dev)
    counts = torch.from_numpy(
        rng.integers(0, 50, (depth, width)).astype(np.int32)).to(dev)
    salts = make_salts(depth, seed=depth)
    want = t_cm_ref.countmin_update_keys(counts.clone(), keys, add, salts)
    before = dict(k.countmin_update.launches_by_route)
    got = k.countmin_update_keys(counts.clone(), keys, add, salts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert k.countmin_update.launches_by_route == {
        "cols": before["cols"], "keys": before["keys"] + 1}


@pytest.mark.parametrize("n_buckets,width", [(32, 128), (8, 128), (1, 1)])
@pytest.mark.parametrize("tick_on_card", [True, False])
def test_ages_route_matches_plain_composition_on_card(n_buckets, width,
                                                      tick_on_card):
    """Ages at every bucket edge, int32 max and negative (future-stamped)
    ones, the tick read on the card or passed as an int; and a tick near
    int32 max whose differences wrap.  The counted ages' int32 sum, added
    in place, equals the plain one with its wrap-around."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.histogram import kernel as hk
    rng = np.random.default_rng(n_buckets)
    dev = torch.device("cuda")
    for tick in (2**26, I32[1], 5):
        ages = np.asarray(_edge_ages(), np.int64)
        ts = ((tick - ages + 2**31) % 2**32 - 2**31).astype(np.int32)
        ts = np.tile(ts, 40)
        B = ts.size
        tt = torch.from_numpy(ts).to(dev)
        add = torch.from_numpy((rng.random(B) < 0.9).astype(np.int32)).to(dev)
        counts = torch.from_numpy(
            rng.integers(0, 50, (1, width)).astype(np.int32)).to(dev)
        t = torch.tensor(tick, dtype=torch.int32, device=dev) \
            if tick_on_card else tick
        sums = [torch.full((), 2**31 - 7, dtype=torch.int32, device=dev)
                for _ in range(2)]
        want = t_hist_ref.histogram_update_ages(
            counts.clone(), torch.tensor(tick, dtype=torch.int32, device=dev),
            tt, add, n_buckets=n_buckets, lat_sum=sums[0])
        before = dict(hk.histogram_update.launches_by_route)
        got = hk.histogram_update_ages(counts.clone(), t, tt, add,
                                       n_buckets=n_buckets, lat_sum=sums[1])
        torch.cuda.synchronize()
        assert torch.equal(got, want), tick
        # the ages' int32 sum wraps past 2**31 many times over
        assert torch.equal(sums[0], sums[1]), tick
        assert hk.histogram_update.launches_by_route == {
            "cols": before["cols"], "ages": before["ages"] + 1}


def test_fused_routes_refuse_what_they_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.countmin import kernel as k
    from repro_torch.kernels.histogram import kernel as hk
    dev = torch.device("cuda")
    keys = torch.zeros(10, dtype=torch.int32, device=dev)
    add = torch.ones(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="depth <= 8"):
        k.countmin_update_keys(
            torch.zeros((9, 64), dtype=torch.int32, device=dev), keys, add,
            make_salts(9))
    with pytest.raises(ValueError, match="n_buckets <= width"):
        hk.histogram_update_ages(
            torch.zeros((1, 16), dtype=torch.int32, device=dev), 3, keys,
            add, n_buckets=32,
            lat_sum=torch.zeros((), dtype=torch.int32, device=dev))


def test_engine_telemetry_on_card_equals_cpu():
    """``Engine.run`` with telemetry on the card (kernels, pinned-memory
    window reads) gives the CPU run's state and reports, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch import convert
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.event import EventBatch
    from repro_torch.core.operators import AssociativeUpdater, Mapper
    from repro_torch.core.workflow import Workflow
    from repro_torch.kernels.countmin import kernel as k
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.telemetry import TelemetryConfig
    spec = {"x": ((), torch.int32)}

    class Pass(Mapper):
        name, subscribes, in_value_spec = "M1", ("S1",), spec
        out_streams = {"S2": spec}

        def map_batch(self, b):
            return {"S2": EventBatch(b.sid, b.ts + 1, b.key, b.value,
                                     b.valid)}

    class Count(AssociativeUpdater):
        name, subscribes, in_value_spec = "U1", ("S2",), spec
        out_streams, table_capacity, sum_mergeable = {}, 4096, True

        def slate_spec(self):
            return {"n": ((), torch.int32)}

        def lift(self, b):
            return {"n": b.value["x"]}

        def combine(self, a, b):
            return {"n": a["n"] + b["n"]}

        merge = combine

    rng = np.random.default_rng(4)
    p = np.arange(1, 501, dtype=np.float64) ** -1.2
    feeds = [(rng.choice(500, 1000, p=p / p.sum()).astype(np.int32),
              rng.integers(0, 5, 1000).astype(np.int32),
              np.maximum(t - rng.integers(0, 30, 1000), 0).astype(np.int32))
             for t in range(24)]

    def run(dev):
        eng = Engine(Workflow([Pass(), Count()], external_streams=("S1",)),
                     EngineConfig(batch_size=1024, queue_capacity=4096,
                                  chunk_size=4,
                                  telemetry=TelemetryConfig(window=8)),
                     device=dev)
        reports = []

        class H:
            state = None
            on_telemetry = staticmethod(reports.append)

        def src(t, _):
            key, x, ts = (torch.from_numpy(a).to(dev) for a in feeds[t])
            return {"S1": EventBatch.of(key, {"x": x}, ts=ts)}

        st, _ = eng.run(eng.init_state(), src, 24, handle=H())
        return convert.state_to_numpy(st), reports

    before = (dict(k.countmin_update.launches_by_route),
              dict(hk.histogram_update.launches_by_route))
    gpu, gpu_reports = run("cuda")
    # every telemetry launch took a fused route
    assert k.countmin_update.launches_by_route["keys"] > before[0]["keys"]
    assert k.countmin_update.launches_by_route["cols"] == before[0]["cols"]
    assert hk.histogram_update.launches_by_route["ages"] > before[1]["ages"]
    assert hk.histogram_update.launches_by_route["cols"] == before[1]["cols"]
    cpu, cpu_reports = run("cpu")

    def eq(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for key in a:
                eq(a[key], b[key])
        else:
            assert np.array_equal(a, b)

    eq(cpu, gpu)
    assert len(cpu_reports) == len(gpu_reports) == 3
    for a, b in zip(cpu_reports, gpu_reports):
        da, db = a.to_dict(), b.to_dict()
        da.pop("window_s"), db.pop("window_s")
        assert da == db
    assert gpu_reports[-1].heavy_hitters[0][0] == 0
