"""Device-side telemetry (port of ``repro.telemetry``, DESIGN.md 13 and
18): a count-min key-heat sketch and per-arc latency histograms updated
inside the tick (``kernels/countmin``, ``kernels/histogram``), a
windowed metrics registry read at window boundaries, span tracing and
the Prometheus exposition, and the closed-loop controller
(``LoadAutoscaler``) that reads the registry's reports.
"""
from repro_torch.telemetry.controller import Action, LoadAutoscaler
from repro_torch.telemetry.metrics import (MetricsRegistry, TelemetryConfig,
                                           TelemetryReport)
from repro_torch.telemetry.prom import render_prometheus
from repro_torch.telemetry.trace import ControlLog, Tracer, null_span

__all__ = ["Action", "ControlLog", "LoadAutoscaler", "MetricsRegistry", "TelemetryConfig",
           "TelemetryReport", "Tracer", "null_span", "render_prometheus"]
