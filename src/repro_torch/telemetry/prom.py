"""Prometheus text-format exposition (version 0.0.4); a copy of
``repro.telemetry.prom``, which the port may not import.

Renders the engine's lifetime counters (``stats()``), the latest
``TelemetryReport`` window gauges, and the cumulative device latency
histograms as native ``_bucket``/``_sum``/``_count`` series.  The
power-of-two device buckets map directly onto Prometheus cumulative
``le`` buckets (upper edge ``2^b`` ticks, top bucket ``+Inf``), so a
standard ``histogram_quantile()`` over the scraped series agrees with
the report's interpolated ``event_latency_p*``.

Everything here renders from snapshots the engine already holds
(``MetricsRegistry.last`` / ``hist_cum``) — a scrape never touches
device state.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.telemetry import latency as lat_mod

_PREFIX = "muppet"


def _esc(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _labels(d: Optional[Dict[str, Any]]) -> str:
    if not d:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in d.items())
    return "{" + inner + "}"


def _num(v: Any) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Doc:
    """Accumulates samples grouped by metric family (HELP/TYPE once)."""

    def __init__(self):
        self._fam: Dict[str, Dict[str, Any]] = {}
        self._order: List[str] = []

    def add(self, name: str, kind: str, help_: str, value: Any,
            labels: Optional[Dict[str, Any]] = None,
            suffix: str = ""):
        name = f"{_PREFIX}_{name}"
        if name not in self._fam:
            self._fam[name] = {"kind": kind, "help": help_,
                               "samples": []}
            self._order.append(name)
        self._fam[name]["samples"].append(
            (name + suffix + _labels(labels), _num(value)))

    def render(self) -> str:
        out = []
        for name in self._order:
            fam = self._fam[name]
            out.append(f"# HELP {name} {fam['help']}")
            out.append(f"# TYPE {name} {fam['kind']}")
            for series, value in fam["samples"]:
                out.append(f"{series} {value}")
        return "\n".join(out) + "\n"


def render_prometheus(*, stats: Optional[Dict[str, Any]] = None,
                      report: Any = None,
                      hist: Optional[Dict[str, Any]] = None,
                      n_buckets: int = lat_mod.N_BUCKETS) -> str:
    """Render a /metrics payload.

    ``stats``: engine lifetime counters (``Engine.stats`` shape);
    ``report``: the latest ``TelemetryReport`` (or None before the
    first window); ``hist``: cumulative per-arc latency histograms
    (``MetricsRegistry.hist_cum`` shape: arc -> {"counts", "sum"}).
    """
    doc = _Doc()
    if stats:
        _render_stats(doc, stats)
    if report is not None:
        _render_report(doc, report)
    if hist:
        _render_hist(doc, hist, n_buckets)
    return doc.render()


def _render_stats(doc: _Doc, stats: Dict[str, Any]):
    counters = {"exchange_dropped": "events dropped at shard exchange",
                "throttle_hits": "events shed at admission",
                "deferred": "run tails re-queued by hotspot backpressure",
                "shed_requests": "requests shed at admission",
                "completed": "requests completed"}
    if "tick" in stats:
        doc.add("tick", "gauge", "engine tick at last read",
                stats["tick"])
    for k, v in (stats.get("processed") or {}).items():
        doc.add("processed_total", "counter",
                "events processed per operator", v, {"op": k})
    for k, v in (stats.get("queue_dropped") or {}).items():
        doc.add("queue_dropped_total", "counter",
                "events dropped per queue", v, {"queue": k})
    for k, v in (stats.get("table_occupancy") or {}).items():
        doc.add("table_rows", "gauge",
                "slate rows resident per updater", v, {"updater": k})
    for k, v in stats.items():
        if k in ("tick", "processed", "queue_dropped",
                 "table_occupancy"):
            continue
        if isinstance(v, (bool,)) or not isinstance(v, (int, float)):
            continue
        kind = "counter" if k in counters else "gauge"
        doc.add(f"{k}{'_total' if kind == 'counter' else ''}", kind,
                counters.get(k, f"engine stat {k}"), v)


def _render_report(doc: _Doc, report: Any):
    per_shard = {"pressure": "EMA normalized load per shard",
                 "events_per_tick": "EMA events per tick per shard",
                 "queue_depth": "standing backlog per shard",
                 "events": "events processed this window per shard",
                 "dropped_delta": "drops this window per shard",
                 "occupancy": "slate rows resident per shard"}
    active = list(getattr(report, "active", []) or [])
    for name, help_ in per_shard.items():
        v = np.atleast_1d(np.asarray(getattr(report, name, []),
                                     np.float64))
        for i, x in enumerate(v):
            shard = active[i] if i < len(active) else i
            doc.add(f"window_{name}", "gauge", help_, x,
                    {"shard": shard})
    gauges = {"window_s": "wall seconds covered by the window",
              "ticks": "source ticks covered by the window",
              "migration_pause_s": "EMA reconfigure pause seconds",
              "migration_bytes_moved": "EMA bytes moved per reconfigure",
              "recovery_replay_s": "last recovery restore+replay secs"}
    for name, help_ in gauges.items():
        if hasattr(report, name):
            doc.add(name, "gauge", help_, getattr(report, name))
    for q, name in ((0.5, "event_latency_p50"),
                    (0.9, "event_latency_p90"),
                    (0.99, "event_latency_p99")):
        if hasattr(report, name):
            doc.add("event_latency_ticks", "gauge",
                    "windowed event latency quantile (ticks)",
                    getattr(report, name), {"quantile": q})
    for arc, p99 in (getattr(report, "queue_delay_p99", None)
                     or {}).items():
        doc.add("queue_delay_p99_ticks", "gauge",
                "windowed per-arc queue-delay p99 (ticks)", p99,
                {"arc": arc})


def _render_hist(doc: _Doc, hist: Dict[str, Any], n_buckets: int):
    for arc, h in hist.items():
        counts = np.asarray(h["counts"], np.float64).ravel()[:n_buckets]
        cum = 0.0
        for b, c in enumerate(counts):
            cum += c
            # inclusive integer upper edge: bucket b holds latencies
            # in [2^(b-1), 2^b), i.e. up to 2^b - 1 ticks
            le = ("+Inf" if b >= n_buckets - 1
                  else lat_mod.bucket_hi(b) - 1)
            doc.add("event_latency_ticks_hist", "histogram",
                    "event latency at updater dequeue (ticks)", cum,
                    {"arc": arc, "le": le}, suffix="_bucket")
        doc.add("event_latency_ticks_hist", "histogram",
                "event latency at updater dequeue (ticks)",
                float(h.get("sum", 0)), {"arc": arc}, suffix="_sum")
        doc.add("event_latency_ticks_hist", "histogram",
                "event latency at updater dequeue (ticks)",
                float(counts.sum()), {"arc": arc}, suffix="_count")
