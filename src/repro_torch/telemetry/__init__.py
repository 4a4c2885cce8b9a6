"""Device-side telemetry (port of ``repro.telemetry``, DESIGN.md 13 and
18): a count-min key-heat sketch and per-arc latency histograms updated
inside the tick (``kernels/countmin``, ``kernels/histogram``), a
windowed metrics registry read at window boundaries, span tracing and
the Prometheus exposition.

The closed-loop controller (``telemetry/controller.py``,
``LoadAutoscaler``) serves only the multi-shard engine and the front
door, and is ported with them.
"""
from repro_torch.telemetry.metrics import (MetricsRegistry, TelemetryConfig,
                                           TelemetryReport)
from repro_torch.telemetry.prom import render_prometheus
from repro_torch.telemetry.trace import ControlLog, Tracer, null_span

__all__ = ["ControlLog", "MetricsRegistry", "TelemetryConfig",
           "TelemetryReport", "Tracer", "null_span", "render_prometheus"]
