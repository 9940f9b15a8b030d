"""Telemetry: span tracing, the metrics registry, posterior diagnostics,
SLOs and the crash flight recorder.

Counterpart of ``dist_svgd_tpu/telemetry`` with the same ``__all__``:

- :mod:`~dist_svgd_torch.telemetry.metrics` — thread-safe **registry** of
  counters / gauges / histograms with Prometheus text exposition;
- :mod:`~dist_svgd_torch.telemetry.trace` — **span tracer** (nestable
  thread-aware spans, ``torch.cuda.synchronize`` fences, lane trees, a
  ``kernel_build`` instant per hand-kernel build; a shared no-op while
  disabled; Chrome trace-event JSON and JSONL) and the **flight
  recorder**;
- :mod:`~dist_svgd_torch.telemetry.diagnostics` — **posterior health**
  on the device (KSD, kernel ESS, collapse, shard divergence) as
  ``svgd_diag_*`` gauges;
- :mod:`~dist_svgd_torch.telemetry.slo` — **declarative SLOs** over the
  registry (burn rates, gauge ceilings, staleness);
- :mod:`~dist_svgd_torch.telemetry.profile` — the **dispatch profiler**:
  per-program attribution of every ``Plan`` program's fenced dispatch
  wall (``svgd_prog_dispatch_*``);
- :mod:`~dist_svgd_torch.telemetry.usage` — the per-tenant **usage
  meter** (``svgd_usage_*``) the serving layer feeds;
- :mod:`~dist_svgd_torch.telemetry.history` — **telemetry history**: a
  bounded on-disk ring of periodic window-delta registry snapshots, in
  JAX's record format.

Quickstart::

    from dist_svgd_torch import telemetry

    tracer = telemetry.enable()             # spans now record
    ...train...
    telemetry.disable().export_chrome("trace.json")

    print(telemetry.default_registry().exposition())   # Prometheus text
"""

from dist_svgd_torch.telemetry.metrics import (
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    combined_exposition,
    default_registry,
    dump_delta,
)
from dist_svgd_torch.telemetry.trace import (
    TRACE_HEADER,
    FlightRecorder,
    SpanHandle,
    Tracer,
    disable,
    enable,
    enabled,
    flight_recorder,
    get_trace_context,
    get_tracer,
    install_flight_recorder,
    instant,
    mint_trace_id,
    record_flight,
    set_trace_context,
    span,
    uninstall_flight_recorder,
)

__all__ = [
    "LATENCY_BUCKETS_S",
    "TRACE_HEADER",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "combined_exposition",
    "default_registry",
    "dump_delta",
    "get_trace_context",
    "mint_trace_id",
    "set_trace_context",
    "FlightRecorder",
    "SpanHandle",
    "Tracer",
    "disable",
    "enable",
    "enabled",
    "flight_recorder",
    "get_tracer",
    "install_flight_recorder",
    "instant",
    "record_flight",
    "span",
    "uninstall_flight_recorder",
    # lazy modules — resolved on first attribute access
    "DiagnosticsConfig",
    "PosteriorDiagnostics",
    "ReloadPolicy",
    "ensemble_health",
    "SloEngine",
    "LatencyObjective",
    "RatioObjective",
    "GaugeCeiling",
    "StalenessObjective",
    "FreshnessObjective",
    "default_serving_slos",
    "default_training_slos",
    "default_streaming_slos",
    "DispatchProfiler",
    "enable_profiler",
    "disable_profiler",
    "get_profiler",
    "profiler_enabled",
    "UsageMeter",
    "enable_usage",
    "disable_usage",
    "get_meter",
    "usage_enabled",
    "usage_summary",
    "TelemetryHistory",
    "HistoryRecorder",
]

_LAZY = {
    "DiagnosticsConfig": "diagnostics",
    "PosteriorDiagnostics": "diagnostics",
    "ReloadPolicy": "diagnostics",
    "ensemble_health": "diagnostics",
    "SloEngine": "slo",
    "LatencyObjective": "slo",
    "RatioObjective": "slo",
    "GaugeCeiling": "slo",
    "StalenessObjective": "slo",
    "FreshnessObjective": "slo",
    "default_serving_slos": "slo",
    "default_training_slos": "slo",
    "default_streaming_slos": "slo",
    "DispatchProfiler": "profile",
    "enable_profiler": "profile",
    "disable_profiler": "profile",
    "get_profiler": "profile",
    "profiler_enabled": "profile",
    "UsageMeter": "usage",
    "enable_usage": "usage",
    "disable_usage": "usage",
    "get_meter": "usage",
    "usage_enabled": "usage",
    "usage_summary": "usage",
    "TelemetryHistory": "history",
    "HistoryRecorder": "history",
}


def __getattr__(name):
    """PEP 562 lazy re-exports (the diagnostics module imports the kernel
    ops)."""
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{submodule}"), name)
    globals()[name] = value  # cache: later lookups skip __getattr__
    return value
