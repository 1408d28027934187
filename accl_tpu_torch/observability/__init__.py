"""End-to-end observability of the port: per-call trace spans (Perfetto
export), the metrics registry the driver, the gang engine and the bench
harnesses publish into, the always-on flight recorder, the hang watchdog
with its health/OpenMetrics surface, and the performance observatory:
cross-rank critical-path attribution, the engine telemetry sampler with
its link matrix, the regression sentinel and the per-tenant SLO tracker.

Port of ``accl_tpu/observability``, whole, exporting what the reference
package exports."""

from .attribution import (  # noqa: F401
    attribute,
    estimate_clock_skew,
)
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
from .sentinel import (  # noqa: F401
    Baseline,
    Sentinel,
)
from .telemetry import (  # noqa: F401
    ENGINE_STATS_FIELDS_V1,
    TelemetrySampler,
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
