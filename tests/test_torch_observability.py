"""Port parity: latency observability and the live read surface — exact
power-of-two bucketing, the histogram update, quantiles, the Prometheus
text, the tracer's spans around ``Engine.run``, the hot-key cache and
the HTTP slate server (``/slate``, ``/slates``, ``/status``,
``/metrics``).  The same numpy inputs go through the JAX package and the
port; integer results are compared bitwise and rendered text byte for
byte."""
import json
import re
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core.engine import Engine as JEngine
from repro.core.engine import EngineConfig as JConfig
from repro.core.workflow import Workflow as JWorkflow
from repro.kernels.histogram import histogram_update as j_hist
from repro.slates.replica import HotKeyCache as JHotKeyCache
from repro.telemetry import latency as jlat
from repro.telemetry.metrics import TelemetryConfig as JTelemetry
from repro.telemetry.metrics import TelemetryReport as JReport
from repro.telemetry.prom import render_prometheus as j_render
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import StateHandle
from repro_torch.core.workflow import Workflow as TWorkflow
from repro_torch.kernels.histogram import histogram_update as t_hist
from repro_torch.slates.replica import HotKeyCache as THotKeyCache
from repro_torch.telemetry import latency as tlat
from repro_torch.telemetry import render_prometheus as t_render
from repro_torch.telemetry.metrics import TelemetryConfig as TTelemetry
from repro_torch.telemetry.metrics import TelemetryReport as TReport
from tests.conftest import CountingUpdater, PassThroughMapper
from tests.test_torch_engine import (TCountingUpdater, TPassThroughMapper,
                                     _jb, _tb)

I32_MAX = 2**31 - 1


def _edges():
    vals = [0, 1]
    for k in range(1, 31):
        vals += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    return [v for v in vals if v <= I32_MAX] + [I32_MAX, -1, -5, -2**31]


# ---- bucketing ----
@pytest.mark.parametrize("n_buckets", [32, 8, 1])
def test_bucketize_exact_edges_match_jax(n_buckets):
    """0, 1, 2**k - 1, 2**k, 2**k + 1 for k up to 30, int32 max and
    negative ages: the integer bit-length of the port equals the JAX
    package's ``32 - clz``, bucket for bucket."""
    vals = np.asarray(_edges(), np.int32)
    want = np.asarray(jlat.bucketize(jnp.asarray(vals), n_buckets))
    got = tlat.bucketize(torch.from_numpy(vals), n_buckets)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    if n_buckets == 32:       # the exact edges, stated
        expect = [0, 1] + [b for k in range(1, 31)
                           for b in (k, k + 1, k + 1)] + [31, 0, 0, 0]
        assert got.numpy().tolist() == expect


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("rows,width,B", [(3, 128, 64), (1, 128, 1000)])
def test_histogram_update_matches_jax_bitwise(impl, rows, width, B):
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 50, (rows, width)).astype(np.int32)
    cols = rng.integers(0, width, (rows, B)).astype(np.int32)
    add = rng.integers(0, 2, B).astype(np.int32)
    want = np.asarray(j_hist(jnp.asarray(counts), jnp.asarray(cols),
                             jnp.asarray(add), impl=impl))
    got = t_hist(torch.from_numpy(counts.copy()), torch.from_numpy(cols),
                 torch.from_numpy(add)).numpy()
    assert np.array_equal(got, want)


def test_histogram_update_any_width_and_cpu_stays_plain():
    from repro_torch.kernels.histogram import kernel as hk
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 50, (2, 40)).astype(np.int32)
    cols = rng.integers(0, 40, (2, 99)).astype(np.int32)
    add = rng.integers(0, 2, 99).astype(np.int32)
    want = np.asarray(j_hist(jnp.asarray(counts), jnp.asarray(cols),
                             jnp.asarray(add), impl="ref"))
    before = hk.histogram_update.launches
    got = t_hist(torch.from_numpy(counts.copy()), torch.from_numpy(cols),
                 torch.from_numpy(add)).numpy()
    assert np.array_equal(got, want)
    assert hk.histogram_update.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        t_hist(torch.from_numpy(counts), torch.from_numpy(cols),
               torch.from_numpy(add), impl="cuda")


@pytest.mark.parametrize("n_buckets", [32, 8])
def test_hist_update_matches_jax(n_buckets):
    """Counts and latency sum of one arc, ages at the bucket edges and
    past the top bucket, invalid rows and future-stamped events."""
    rng = np.random.default_rng(9)
    ages = np.asarray([v for v in _edges() if v < 2**26], np.int32)
    B = ages.size
    tick = np.int32(2**26)
    ts = (tick - ages).astype(np.int32)
    valid = rng.random(B) < 0.8
    jh = jlat.make_hist(["U1"], n_buckets)["U1"]
    th = tlat.make_hist(["U1"], n_buckets, device="cpu")["U1"]
    for _ in range(2):
        jh = jlat.hist_update(jh, jnp.asarray(tick), jnp.asarray(ts),
                              jnp.asarray(valid), n_buckets=n_buckets,
                              impl="ref")
        th = tlat.hist_update(th, torch.tensor(tick), torch.from_numpy(ts),
                              torch.from_numpy(valid), n_buckets=n_buckets)
    assert th["counts"].shape == (1, tlat.pad_width(n_buckets))
    assert np.array_equal(np.asarray(jh["counts"]), th["counts"].numpy())
    assert int(jh["sum"]) == int(th["sum"])


def test_quantile_and_quantiles_match_jax():
    rng = np.random.default_rng(10)
    cases = [np.zeros(32), rng.integers(0, 100, 32).astype(np.float64)]
    top = np.zeros(8)
    top[7] = 10
    sparse = np.zeros(32)
    sparse[[2, 9]] = [3, 1]
    cases += [top, sparse]
    qs = (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)
    for c in cases:
        nb = c.size
        for q in qs:
            a = jlat.quantile(c, q, n_buckets=nb)
            b = tlat.quantile(c, q, n_buckets=nb)
            assert type(b) is float and a == b, (q, a, b)
        assert jlat.quantiles(c, qs, n_buckets=nb) == \
            tlat.quantiles(c, qs, n_buckets=nb)


# ---- exposition and tracing ----
def _report(cls):
    return cls(
        tick=7, ticks=4, n_shards=1, active=[0], window_s=0.1,
        events=np.asarray([32.0]), events_per_tick=np.asarray([8.0]),
        queue_depth=np.asarray([3.0]), queue_peak_delta=np.asarray([0.0]),
        dropped_delta=np.asarray([0.0]), occupancy=np.asarray([12.0]),
        pressure=np.asarray([0.5]), heavy_hitters=[(5, 9, 0.25)],
        migration_pause_s=0.0, event_latency_p50=2.0,
        event_latency_p90=3.5, event_latency_p99=3.9,
        queue_delay_p99={"U1": 3.9, "U2": 1.5})


@pytest.mark.parametrize("nb", [32, 8])
def test_render_prometheus_text_equals_jax(nb):
    rng = np.random.default_rng(11)
    hist = {a: {"counts": rng.integers(0, 20, (1, 128)).astype(np.int32),
                "sum": float(rng.integers(0, 1000))} for a in ("U1", "U2")}
    stats = {"tick": 7, "throttle_hits": 2, "deferred": 1,
             "processed": {"M1": 10, "U1": 9},
             "queue_dropped": {"U1": 1, "M1": 0},
             "queue_peak": {"U1": 4}, "table_occupancy": {"U1": 12},
             "table_dropped": {"U1": 0}}
    want = j_render(stats=stats, report=_report(JReport), hist=hist,
                    n_buckets=nb)
    got = t_render(stats=stats, report=_report(TReport), hist=hist,
                   n_buckets=nb)
    assert got == want
    assert 'muppet_event_latency_ticks_hist_bucket{arc="U2",le="+Inf"}' in got


def _wf_pair(window=4, trace=False, lag=2):
    jwf = JWorkflow([PassThroughMapper(), CountingUpdater()],
                    external_streams=("S1",))
    twf = TWorkflow([TPassThroughMapper(), TCountingUpdater()],
                    external_streams=("S1",))
    base = dict(batch_size=32, queue_capacity=128, chunk_size=4)
    kw = dict(window=window, trace=trace)
    jeng = JEngine(jwf, JConfig(**base, telemetry=JTelemetry(**kw,
                                                             impl="ref")))
    teng = TEngine(twf, TConfig(**base, telemetry=TTelemetry(**kw)),
                   device="cpu")

    def feed(t):
        return {"key": (np.arange(16) % 6 + t % 3).astype(np.int32),
                "x": np.full(16, t % 5, np.int32),
                "ts": np.full(16, max(t - lag, 0), np.int32),
                "valid": np.ones(16, bool)}
    return jeng, teng, feed


def test_tracer_spans_of_run_and_chrome_trace(tmp_path):
    """A traced run records ``chunk_dispatch`` per chunk and one
    ``observe_begin`` / ``observe_finish`` pair per window — the JAX
    engine's names and counts — and exports loadable Chrome trace JSON."""
    jeng, teng, feed = _wf_pair(window=4, trace=True)
    jeng.run(jeng.init_state(), lambda t, m: {"S1": _jb(feed(t))}, 12)
    teng.run(teng.init_state(), lambda t, m: {"S1": _tb(feed(t))}, 12)
    names = lambda eng: [e["name"] for e in eng.tracer.events()]
    assert names(teng) == names(jeng)
    assert names(teng).count("chunk_dispatch") == 3
    assert names(teng).count("observe_begin") == 3
    assert names(teng).count("observe_finish") == 3
    assert [s["args"]["tick"] for s in teng.tracer.spans("observe_begin")] \
        == [4, 8, 12]
    doc = json.load(open(teng.tracer.export(str(tmp_path / "t.json"))))
    assert doc["displayTimeUnit"] == "ms"
    for e in doc["traceEvents"]:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                "args"} <= set(e) and e["ph"] == "X" and e["dur"] >= 0
    assert TEngine(TWorkflow([TPassThroughMapper(), TCountingUpdater()],
                             external_streams=("S1",)),
                   TConfig(telemetry=TTelemetry()), device="cpu") \
        .tracer is None


def test_control_log_jsonl(tmp_path):
    from repro_torch.telemetry import ControlLog
    p = tmp_path / "ctl.jsonl"
    log = ControlLog(str(p))
    log.log({"tick": 8, "pressure": np.asarray([0.5, 0.25]),
             "n": torch.tensor(3)})
    log.close()
    rec = json.loads(p.read_text())
    assert rec == {"tick": 8, "pressure": [0.5, 0.25], "n": 3}


# ---- the read surface ----
@pytest.mark.parametrize("cls", [JHotKeyCache, THotKeyCache],
                         ids=["jax", "port"])
def test_hot_key_cache_warm_get_invalidate(cls):
    """The port's cache behaves as the JAX package's on one script:
    admission, LRU eviction, TTL expiry, invalidation."""
    clock = [0.0]
    c = cls(capacity=2, ttl_s=10.0, clock=lambda: clock[0])
    c.put("U1", 1, {"v": 1})            # not admitted -> dropped
    assert c.get("U1", 1) == (False, None)
    c.warm([1, 2, 3])
    c.put("U1", 1, {"v": 1})
    c.put("U1", 2, {"v": 2})
    assert c.get("U1", 1) == (True, {"v": 1})
    c.put("U1", 3, {"v": 3})            # evicts LRU (=2, 1 was touched)
    assert c.get("U1", 2) == (False, None)
    assert c.get("U1", 1) == (True, {"v": 1})
    clock[0] = 11.0                     # TTL expiry
    assert c.get("U1", 1) == (False, None)
    c.put("U1", 3, {"v": 3})
    c.invalidate()
    assert len(c) == 0 and c.hot_keys() == [1, 2, 3]
    assert c.stats() == {"entries": 0, "hot_keys": 3, "hits": 2,
                         "misses": 3, "invalidations": 1}
    with pytest.raises(ValueError):
        cls(capacity=0)


_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (\+Inf|-?[0-9.e+-]+)$')


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def test_state_handle_serve_slates_status_metrics():
    """``StateHandle.serve`` on the CPU: point and batched slate reads,
    ``/status`` equal to ``stats()``, 404s, and a ``/metrics`` page that
    parses, equals the JAX engine's for the same run and carries the
    ``_bucket`` / ``_sum`` / ``_count`` series with cumulative buckets."""
    from repro.core.engine import StateHandle as JHandle
    jeng, teng, feed = _wf_pair(window=4, lag=3)
    jst, _ = jeng.run(jeng.init_state(),
                      lambda t, m: {"S1": _jb(feed(t))}, 8)
    tst, _ = teng.run(teng.init_state(),
                      lambda t, m: {"S1": _tb(feed(t))}, 8)
    h = StateHandle(teng, tst)
    srv = h.serve()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        code, _, body = _get(f"{url}/slate/U1/2")
        want = teng.read_slate(tst, "U1", 2)
        assert code == 200 and json.loads(body) == {
            k: v.item() for k, v in want.items()}
        _, _, body = _get(f"{url}/slates/U1?keys=2,3,999")
        got = json.loads(body)["slates"]
        assert got["999"] is None and got["3"]["count"] == \
            int(teng.read_slate(tst, "U1", 3)["count"])
        _, _, body = _get(f"{url}/status")
        assert json.loads(body) == teng.stats(tst)
        for path, status in (("/slate/U1/999", 404), ("/nope", 404),
                             ("/slates/U1", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(url + path)
            assert e.value.code == status
        code, ctype, text = _get(f"{url}/metrics")
    finally:
        srv.close()
    assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
    jtext = JHandle(jeng, jst).metrics_text()
    strip = lambda s: re.sub(r"(muppet_window_s) \S+", r"\1 _", s)
    assert strip(text) == strip(jtext)
    kinds = {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split()
            kinds[name] = kind
        elif not line.startswith("#"):
            assert _SAMPLE.match(line), line
    assert kinds["muppet_processed_total"] == "counter"
    assert kinds["muppet_event_latency_ticks_hist"] == "histogram"
    buckets = re.findall(
        r'muppet_event_latency_ticks_hist_bucket\{arc="U1",le="([^"]+)"\}'
        r' ([0-9.e+]+)', text)
    cums = [float(v) for _, v in buckets]
    assert buckets[-1][0] == "+Inf" and cums == sorted(cums) and cums[-1] > 0
    count = re.search(r'muppet_event_latency_ticks_hist_count\{arc="U1"\} '
                      r'([0-9.e+]+)', text)
    assert float(count.group(1)) == cums[-1]
    assert re.search(r'muppet_event_latency_ticks_hist_sum\{arc="U1"\} '
                     r'[1-9]', text)
    assert [b for b, _ in buckets[:4]] == ["0", "1", "3", "7"]


def test_report_quantiles_from_lagged_feed_match_jax():
    """Sources stamped 3 ticks in the past: the pooled quantiles and the
    per-arc p99 land in the lag's bucket, equal to the JAX engine's."""
    jeng, teng, feed = _wf_pair(window=4, lag=3)
    jeng.run(jeng.init_state(), lambda t, m: {"S1": _jb(feed(t))}, 16)
    teng.run(teng.init_state(), lambda t, m: {"S1": _tb(feed(t))}, 16)
    a, b = jeng.telemetry.last, teng.telemetry.last
    assert 0 < b.event_latency_p50 <= b.event_latency_p90 \
        <= b.event_latency_p99 <= 8.0
    for f in ("event_latency_p50", "event_latency_p90",
              "event_latency_p99", "queue_delay_p99", "heavy_hitters"):
        assert getattr(a, f) == getattr(b, f), f
    json.dumps(b.to_dict())
