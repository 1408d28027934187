"""End-to-end observability of the port: per-call trace spans (Perfetto
export), the metrics registry the driver, the gang engine and the bench
harnesses publish into, the always-on flight recorder, and the hang
watchdog with its health/OpenMetrics surface.

Port of ``accl_tpu/observability``: ``metrics``, ``trace``, ``flight``
and ``health`` whole, exporting what the reference package exports from
them.  The reference's ``attribution``, ``sentinel``, ``telemetry`` and
``slo`` modules are not ported yet, so ``attribute``,
``estimate_clock_skew``, ``Baseline``, ``Sentinel``,
``ENGINE_STATS_FIELDS_V1`` and ``TelemetrySampler`` are absent here."""

from .flight import (  # noqa: F401
    FlightRecord,
    FlightRecorder,
    dump_all as dump_all_flight,
    enabled as flight_enabled,
    merge_flight_dumps,
)
from .health import (  # noqa: F401
    HEALTH_DEGRADED,
    HEALTH_HUNG,
    HEALTH_OK,
    HEALTH_SLOW,
    MetricsExporter,
    Watchdog,
    exporter_port,
    start_exporter,
    stop_exporter,
)
from .metrics import (  # noqa: F401
    LATENCY_BUCKETS_US,
    MetricsRegistry,
    busbw_factor,
    default_registry,
    dump_metrics,
    metric_help_for,
    payload_factor,
    size_bucket,
    validate_openmetrics,
)
from .trace import (  # noqa: F401
    TraceCollector,
    TraceSpan,
    collector,
    disable as disable_tracing,
    enable as enable_tracing,
    enabled as tracing_enabled,
    merge_trace_files,
    new_span,
    traced_window,
)
