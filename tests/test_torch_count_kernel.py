"""The count kernel (``csrc/countmin.cu``) against its plain version on
the card, bitwise, through both wrappers (``kernels/countmin`` and
``kernels/histogram``).  Every case needs a CUDA card and skips without
one; the file imports no JAX, so it runs wherever the port does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.countmin import ref as t_cm_ref


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

    before = (k.countmin_update.launches, hk.histogram_update.launches)
    gpu, gpu_reports = run("cuda")
    assert k.countmin_update.launches > before[0]
    assert hk.histogram_update.launches > before[1]
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
