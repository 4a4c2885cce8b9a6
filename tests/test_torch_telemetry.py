"""Port parity: in-tick telemetry — the count-min sketch update, the
sketch's hashing, readout and decay, and ``Engine.run`` with telemetry
on.  The same numpy inputs, made from a seed, go through the JAX package
and the port; integer state is compared bitwise, ``TelemetryReport``s
field by field (all but the wall-clock ``window_s``).  The CUDA kernel is
held against the plain version on the card in
``tests/test_torch_count_kernel.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.engine import Engine as JEngine
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import stack_sources as j_stack
from repro.core.hashing import _mix32_np as j_mix32_np
from repro.core.hashing import fold_u32_np as j_fold_u32_np
from repro.core.workflow import Workflow as JWorkflow
from repro.kernels.countmin import countmin_update as j_countmin
from repro.telemetry import sketch as jsk
from repro.telemetry.metrics import TelemetryConfig as JTelemetry
from repro_torch import convert
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import StateHandle
from repro_torch.core.engine import stack_sources as t_stack
from repro_torch.core.workflow import Workflow as TWorkflow
from repro_torch.kernels.countmin import countmin_update as t_countmin
from repro_torch.telemetry import sketch as tsk
from repro_torch.telemetry.metrics import TelemetryConfig as TTelemetry
from tests.conftest import (CountingUpdater, LastValueUpdater,
                            PassThroughMapper)
from tests.test_torch_engine import (TCountingUpdater, TLastValueUpdater,
                                     TPassThroughMapper, _eq_state, _eq_tree,
                                     _jb, _tb)


def _cm_case(seed, depth, width, B):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, (depth, width)).astype(np.int32)
    cols = rng.integers(0, width, (depth, B)).astype(np.int32)
    add = rng.integers(0, 2, B).astype(np.int32)
    return counts, cols, add


def _port_cm(counts, cols, add, fn=t_countmin):
    return fn(torch.from_numpy(counts.copy()), torch.from_numpy(cols),
              torch.from_numpy(add)).numpy()


# ---- the kernel's function ----
@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("depth,width,B", [(2, 256, 128), (4, 128, 300),
                                           (2, 2048, 1000)])
def test_countmin_update_matches_jax_bitwise(impl, depth, width, B):
    counts, cols, add = _cm_case(0, depth, width, B)
    want = np.asarray(j_countmin(jnp.asarray(counts), jnp.asarray(cols),
                                 jnp.asarray(add), impl=impl))
    assert np.array_equal(_port_cm(counts, cols, add), want)


@pytest.mark.parametrize("depth,width", [(2, 100), (3, 1000), (1, 1)])
def test_countmin_update_any_width_matches_jax_ref(depth, width):
    """Widths that are no multiple of 128 (the TPU kernel's condition):
    the port takes them; the JAX oracle takes any width."""
    counts, cols, add = _cm_case(1, depth, width, 257)
    want = np.asarray(j_countmin(jnp.asarray(counts), jnp.asarray(cols),
                                 jnp.asarray(add), impl="ref"))
    assert np.array_equal(_port_cm(counts, cols, add), want)


def test_countmin_update_is_in_place_and_hot_column_exact():
    counts = torch.zeros((2, 64), dtype=torch.int32)
    cols = torch.full((2, 500), 7, dtype=torch.int32)
    cols[1] = 63
    add = torch.ones(500, dtype=torch.int32)
    add[::5] = 0
    out = t_countmin(counts, cols, add)
    assert out is counts
    assert int(counts[0, 7]) == int(counts[1, 63]) == 400
    assert int(counts.sum()) == 800


def test_cpu_tensor_never_reaches_the_kernel():
    from repro_torch.kernels.countmin import kernel as k
    counts, cols, add = _cm_case(2, 2, 256, 64)
    before = k.countmin_update.launches
    _port_cm(counts, cols, add)
    assert k.countmin_update.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        t_countmin(torch.from_numpy(counts), torch.from_numpy(cols),
                   torch.from_numpy(add), impl="cuda")
    with pytest.raises(ValueError, match="unknown countmin impl"):
        t_countmin(torch.from_numpy(counts), torch.from_numpy(cols),
                   torch.from_numpy(add), impl="pallas")


# ---- hashing, readout, decay ----
@pytest.mark.parametrize("width", [2048, 1000])
def test_columns_int32_match_jax(width):
    rng = np.random.default_rng(4)
    keys = np.concatenate([rng.integers(-2**31, 2**31 - 1, 500),
                           [0, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    salts = jsk.make_salts(3)
    assert np.array_equal(tsk.make_salts(3), salts)
    want = np.asarray(jsk.columns(jnp.asarray(keys), salts, width))
    got = tsk.columns(torch.from_numpy(keys), salts, width).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_columns_int64_match_jax_host_hash():
    """int64 keys: the JAX device path needs x64, so the port is held
    against the JAX package's host hash (``estimate`` reads it; the JAX
    docstring pins it bitwise to the device path).  Non-negative keys
    in the int32 band hash as their int32 selves (the fold is the
    identity there)."""
    rng = np.random.default_rng(5)
    keys = np.concatenate([rng.integers(-2**62, 2**62, 500),
                           [2**33 + 5, -2**40, 2**63 - 1]]).astype(np.int64)
    salts, width = jsk.make_salts(2), 2048
    want = np.stack([j_mix32_np(j_fold_u32_np(keys) ^ np.uint32(s))
                     % np.uint32(width) for s in salts]).astype(np.int32)
    got = tsk.columns(torch.from_numpy(keys), salts, width).numpy()
    assert np.array_equal(got, want)
    band = np.concatenate([np.arange(80), [2**31 - 1]]).astype(np.int64)
    assert np.array_equal(
        tsk.columns(torch.from_numpy(band), salts, width).numpy(),
        tsk.columns(torch.from_numpy(band.astype(np.int32)), salts,
                    width).numpy())


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("B,S", [(128, 32), (16, 64)])
def test_sketch_update_estimate_heavy_hitters_match_jax(key_dtype, B, S):
    """A multi-batch feed with planted hot keys: the whole sketch state
    bitwise, then ``estimate`` and ``heavy_hitters`` of both packages on
    the port's snapshot."""
    rng = np.random.default_rng(6)
    salts = jsk.make_salts(4)
    base = 2**35 if key_dtype == np.int64 else 0
    j = jsk.make_sketch(4, 512, S)
    t = tsk.make_sketch(4, 512, S, key_dtype=torch.from_numpy(
        np.zeros(0, key_dtype)).dtype, device="cpu")
    fed = []
    for _ in range(5):
        keys = np.where(rng.random(B) < 0.4, 77,
                        rng.integers(0, 3000, B)) + base
        keys[rng.random(B) < 0.2] = base - 5
        valid = rng.random(B) < 0.85
        fed.append(keys[valid].astype(key_dtype))
        if key_dtype == np.int32:
            j = jsk.sketch_update(j, jnp.asarray(keys.astype(np.int32)),
                                  jnp.asarray(valid), salts, impl="ref")
        t = tsk.sketch_update(t, torch.from_numpy(keys.astype(key_dtype)),
                              torch.from_numpy(valid), salts)
    tp = convert.to_plain(t)
    if key_dtype == np.int32:
        _eq_tree(convert.to_plain(jax.device_get(j)), tp)
    fed = np.concatenate(fed)
    assert int(tp["total"]) == fed.size == int(tp["sample_n"])
    uniq, true = np.unique(fed, return_counts=True)
    est_j = jsk.estimate(tp["counts"], uniq, salts)
    est_t = tsk.estimate(tp["counts"], uniq, salts)
    assert np.array_equal(est_j, est_t) and np.all(est_t >= true)
    hh_j = jsk.heavy_hitters(tp["counts"], tp["sample"], tp["sample_n"],
                             salts, k=3)
    hh_t = tsk.heavy_hitters(tp["counts"], tp["sample"], tp["sample_n"],
                             salts, k=3)
    assert hh_j == hh_t and hh_t[0][0] == 77 + base


@pytest.mark.parametrize("factor", [0.0, 0.5, 0.9, -1.0])
def test_decay_matches_jax_bitwise(factor):
    """floor(f32(counts) * factor) on both sides, including counts above
    2**24 where f32 rounds."""
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 2**31 - 1, (3, 300)).astype(np.int32)
    counts[0, :50] = rng.integers(0, 40, 50)
    counts[1, :5] = [0, 1, 2**24 + 1, 2**24 - 1, 2**31 - 1]
    jd = jsk.decay({"counts": jnp.asarray(counts)}, factor)
    td = tsk.decay({"counts": torch.from_numpy(counts)}, factor)
    assert td["counts"].dtype == torch.int32
    assert np.array_equal(np.asarray(jd["counts"]), td["counts"].numpy())


# ---- the fused routes' plain compositions ----
I32 = (-2**31, 2**31 - 1)


def _edge_keys(rng, dtype):
    """Random keys over the whole key type plus its extremes: for int64,
    negative keys and keys above 2**32 (they reach the xor-fold)."""
    if dtype == np.int64:
        return np.concatenate([
            rng.integers(-2**62, 2**62, 400), [2**32, 2**32 - 1, -2**32,
                                                2**33 + 5, -1, 0,
                                                2**63 - 1, -2**63],
            np.full(30, 2**40 + 3)]).astype(np.int64)
    return np.concatenate([rng.integers(I32[0], I32[1], 400),
                           [0, -1, I32[1], I32[0]],
                           np.full(30, 77)]).astype(np.int32)


def _edge_ages():
    vals = [0, 1]
    for k in range(1, 31):
        vals += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    return [v for v in vals if v <= I32[1]] + [I32[1], -1, -5, I32[0] + 1]


@pytest.mark.parametrize("depth,width", [(2, 2048), (4, 1000)])
def test_keys_route_plain_composition_matches_jax_sketch_update(depth,
                                                                width):
    """``countmin_update_keys`` on the CPU (the fused route's plain
    version) gives the JAX ``sketch_update``'s counters bitwise at int32
    keys over the whole range; int64 keys against the JAX package's host
    hash (its device path needs x64)."""
    from repro_torch.kernels.countmin import countmin_update_keys
    from repro_torch.kernels.countmin import kernel as k
    rng = np.random.default_rng(depth)
    salts = jsk.make_salts(depth)
    counts = rng.integers(0, 50, (depth, width)).astype(np.int32)
    for dtype in (np.int32, np.int64):
        keys = _edge_keys(rng, dtype)
        valid = rng.random(keys.size) < 0.85
        before = k.countmin_update.launches
        got = countmin_update_keys(
            torch.from_numpy(counts.copy()), torch.from_numpy(keys),
            torch.from_numpy(valid.astype(np.int32)), salts).numpy()
        assert k.countmin_update.launches == before     # CPU: plain
        if dtype == np.int32:
            j = {**jsk.make_sketch(depth, width, 8),
                 "counts": jnp.asarray(counts)}
            j = jsk.sketch_update(j, jnp.asarray(keys), jnp.asarray(valid),
                                  salts, impl="ref")
            want = np.asarray(j["counts"])
        else:
            cols = np.stack([j_mix32_np(j_fold_u32_np(keys) ^ np.uint32(s))
                             % np.uint32(width) for s in salts])
            want = counts.copy()
            for r in range(depth):
                np.add.at(want[r], cols[r][valid].astype(np.int64), 1)
        assert np.array_equal(got, want), dtype


@pytest.mark.parametrize("n_buckets", [32, 8, 1])
def test_ages_route_plain_composition_matches_jax_hist_update(n_buckets):
    """``histogram_update_ages`` on the CPU (the fused route's plain
    version) gives the JAX ``hist_update``'s counts and int32 latency sum
    bitwise (the sum wraps past int32 max) at ages on every bucket edge,
    int32 max and negative, with the tick as a 0-d tensor or an int, and
    a tick near int32 max whose differences wrap."""
    from repro_torch.kernels.histogram import histogram_update_ages
    from repro_torch.telemetry import latency as tlat
    from repro.telemetry import latency as jlat
    rng = np.random.default_rng(n_buckets)
    w = tlat.pad_width(n_buckets)
    for tick in (2**26, I32[1], 5):
        ages = np.asarray(_edge_ages(), np.int64)
        ts = ((tick - ages + 2**31) % 2**32 - 2**31).astype(np.int32)
        valid = rng.random(ts.size) < 0.8
        counts = rng.integers(0, 50, (1, w)).astype(np.int32)
        start = np.int32(2**31 - 7)
        jh = jlat.hist_update({"counts": jnp.asarray(counts),
                               "sum": jnp.asarray(start)},
                              jnp.asarray(np.int32(tick)), jnp.asarray(ts),
                              jnp.asarray(valid), n_buckets=n_buckets,
                              impl="ref")
        for t in (torch.tensor(tick, dtype=torch.int32), tick):
            lat_sum = torch.tensor(start)
            got = histogram_update_ages(
                torch.from_numpy(counts.copy()), t, torch.from_numpy(ts),
                torch.from_numpy(valid.astype(np.int32)),
                n_buckets=n_buckets, lat_sum=lat_sum).numpy()
            assert np.array_equal(got, np.asarray(jh["counts"])), tick
            # the ages sum past int32 max: both wrap the same way
            assert int(lat_sum) == int(jh["sum"]), tick


def test_fused_routes_never_launch_on_the_cpu():
    from repro_torch.kernels.countmin import countmin_update_keys
    from repro_torch.kernels.histogram import histogram_update_ages
    counts = torch.zeros((2, 64), dtype=torch.int32)
    keys = torch.arange(10, dtype=torch.int32)
    add = torch.ones(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        countmin_update_keys(counts, keys, add, jsk.make_salts(2),
                             impl="cuda")
    s = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        histogram_update_ages(counts[:1], torch.tensor(3, dtype=torch.int32),
                              keys, add, n_buckets=32, lat_sum=s,
                              impl="cuda")
    with pytest.raises(ValueError, match="unknown histogram impl"):
        histogram_update_ages(counts[:1], 3, keys, add, n_buckets=32,
                              lat_sum=s, impl="pallas")


# ---- the engine with telemetry on ----
def _workflows():
    j = JWorkflow([PassThroughMapper(), CountingUpdater(),
                   LastValueUpdater()], external_streams=("S1",))
    t = TWorkflow([TPassThroughMapper(), TCountingUpdater(),
                   TLastValueUpdater()], external_streams=("S1",))
    return j, t


def _feeds(seed, ticks, n=14):
    """Zipf-skewed keys with a hot head and event times lagged by up to
    40 ticks, so the sketch ranks and the histograms spread."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, 41, dtype=np.float64) ** -1.3
    out = []
    for t in range(ticks):
        out.append({"key": rng.choice(40, size=n, p=p / p.sum())
                    .astype(np.int32),
                    "x": rng.integers(0, 9, size=n).astype(np.int32),
                    "ts": np.maximum(t - rng.integers(0, 41, n), 0)
                    .astype(np.int32),
                    "valid": rng.random(n) < 0.9})
    return out


class _Capture:
    """A run handle that keeps every report."""

    def __init__(self):
        self.state, self.reports = None, []

    def on_telemetry(self, report):
        self.reports.append(report)

    def on_frontier_advance(self):
        pass


def _eq_report(a, b):
    fa, fb = a.to_dict(), b.to_dict()
    fa.pop("window_s"), fb.pop("window_s")
    assert set(fa) == set(fb)
    for k in fa:
        va, vb = fa[k], fb[k]
        if k == "heavy_hitters":
            va, vb = [list(x) for x in va], [list(x) for x in vb]
        assert va == vb, (k, va, vb)


@pytest.mark.parametrize("j_impl", ["ref", "interpret"])
@pytest.mark.parametrize("decay", [0.0, 0.5])
def test_engine_run_telemetry_matches_jax(j_impl, decay):
    """``Engine.run`` over 20 ticks in chunks of 4 with a window of 4:
    the whole state (sketch and ``lat_hist`` included, through
    ``convert``) and every report but ``window_s`` equal the JAX
    engine's; slates equal the telemetry-off run."""
    feeds = _feeds(11, 20)
    jwf, twf = _workflows()
    kw = dict(width=256, sample=8, window=4, decay=decay, top_k=4)
    base = dict(batch_size=16, queue_capacity=64, chunk_size=4)
    jeng = JEngine(jwf, JConfig(**base, telemetry=JTelemetry(
        **kw, impl=j_impl)))
    teng = TEngine(twf, TConfig(**base, telemetry=TTelemetry(**kw)),
                   device="cpu")
    jh, th = _Capture(), _Capture()
    jst, _ = jeng.run(jeng.init_state(),
                      lambda t, m: {"S1": _jb(feeds[t])}, 20, handle=jh)
    tst, _ = teng.run(teng.init_state(),
                      lambda t, m: {"S1": _tb(feeds[t])}, 20, handle=th)
    assert "sketch" in tst and set(tst["lat_hist"]) == {"U1", "U2"}
    _eq_state(jst, tst)
    assert len(jh.reports) == len(th.reports) == 5
    for a, b in zip(jh.reports, th.reports):
        _eq_report(a, b)
    last = th.reports[-1]
    assert last.heavy_hitters and last.heavy_hitters[0][0] == 0
    assert 0 < last.event_latency_p50 <= last.event_latency_p99
    assert set(last.queue_delay_p99) == {"U1", "U2"}
    _eq_report(jeng.telemetry.last, teng.telemetry.last)
    for arc in ("U1", "U2"):
        assert np.array_equal(jeng.telemetry.hist_cum[arc]["counts"],
                              teng.telemetry.hist_cum[arc]["counts"])

    off = TEngine(_workflows()[1], TConfig(**base), device="cpu")
    ost, _ = off.run(off.init_state(),
                     lambda t, m: {"S1": _tb(feeds[t])}, 20)
    a, b = convert.state_to_numpy(ost), convert.state_to_numpy(tst)
    for part in ("tables", "queues", "processed", "tick"):
        _eq_tree(a[part], b[part], part)


@pytest.mark.parametrize("nb", [0, 32])
def test_run_chunk_parity_telemetry_on_off(nb):
    """The chunk path: outputs, tables and queues are bitwise equal with
    the sketch (and the histograms, ``latency_buckets > 0``) on or off,
    and the telemetry state equals the JAX engine's."""
    feeds = _feeds(12, 8)
    jwf, twf = _workflows()
    base = dict(batch_size=16, queue_capacity=64)
    tel = dict(width=256, latency_buckets=nb)
    on = TEngine(twf, TConfig(**base, telemetry=TTelemetry(**tel)),
                 device="cpu")
    off = TEngine(_workflows()[1], TConfig(**base), device="cpu")
    jeng = JEngine(jwf, JConfig(**base, telemetry=JTelemetry(
        **tel, impl="ref")))
    stacked = lambda: t_stack([{"S1": _tb(d)} for d in feeds])
    s1, o1, _ = on.run_chunk(on.init_state(), stacked())
    s0, o0, _ = off.run_chunk(off.init_state(), stacked())
    assert ("lat_hist" in s1) == (nb > 0)
    a, b = convert.state_to_numpy(s0), convert.state_to_numpy(s1)
    for part in ("tables", "queues", "processed", "tick"):
        _eq_tree(a[part], b[part], part)
    _eq_tree(convert.to_plain(o0), convert.to_plain(o1))
    jst, _, _ = jeng.run_chunk(jeng.init_state(),
                               j_stack([{"S1": _jb(d)} for d in feeds]))
    _eq_state(jst, s1)


def test_state_carried_from_jax_with_telemetry():
    """A mid-stream JAX state with a populated sketch and histograms
    carries into the port, and both engines run on to equal states."""
    feeds = _feeds(13, 10)
    jwf, twf = _workflows()
    base = dict(batch_size=16, queue_capacity=64)
    jeng = JEngine(jwf, JConfig(**base, telemetry=JTelemetry(
        width=256, impl="ref")))
    teng = TEngine(twf, TConfig(**base, telemetry=TTelemetry(width=256)),
                   device="cpu")
    jst = jeng.init_state()
    for d in feeds[:5]:
        jst, _ = jeng.step(jst, {"S1": _jb(d)})
    tst = convert.state_from_numpy(convert.to_plain(jax.device_get(jst)),
                                   device="cpu")
    assert int(tst["sketch"]["total"]) > 0
    _eq_state(jst, tst)
    for d in feeds[5:]:
        jst, _ = jeng.step(jst, {"S1": _jb(d)})
        tst, _ = teng.step(tst, {"S1": _tb(d)})
    _eq_state(jst, tst)


def test_handle_cache_warmed_from_reports():
    """``run`` hands each report to ``StateHandle.on_telemetry``, which
    warms the hot-key cache with the window's heavy hitters; reads of a
    hot key then come from the cache."""
    from repro_torch.slates.replica import HotKeyCache
    feeds = _feeds(14, 12)
    _, twf = _workflows()
    teng = TEngine(twf, TConfig(batch_size=16, queue_capacity=64,
                                chunk_size=4,
                                telemetry=TTelemetry(width=256, window=4)),
                   device="cpu")
    cache = HotKeyCache(capacity=16)
    handle = StateHandle(teng, teng.init_state(), cache=cache)
    teng.run(handle.state, lambda t, m: {"S1": _tb(feeds[t])}, 12,
             handle=handle)
    hot = [k for k, _, _ in teng.telemetry.last.heavy_hitters]
    assert hot and cache.hot_keys() == sorted(hot)
    first = handle.read_slate("U1", hot[0])
    assert first is not None and len(cache) == 1
    assert handle.read_slate("U1", hot[0]) is first      # a cache hit
    assert cache.stats()["hits"] == 1
    handle.on_frontier_advance()
    assert len(cache) == 0
