"""Telemetry (PyTorch port of ``telemetry/``): the per-fit event stream,
the metrics registry, causal trace spans, the crash flight recorder and
the drift sketches.

Fits stream ``fit_start`` / ``round_end`` / ``fit_end`` events (and spans)
to a JSONL sink when the estimator's ``telemetry_path`` is set or
``SE_TPU_TELEMETRY`` names a file, or into memory under
:func:`record_fits`; every ensemble fit attaches ``fit_history_``.  The
streams carry the JAX package's events and keys, so
``tools/telemetry_report.py`` and ``tools/trace_viewer.py`` read them.
The online :class:`Watchdog` (``watchdog.py``) applies the perf
sentinel's thresholds to the live registry and drives ``slo_alert``
events and the verdict the autopilot acts on; :class:`ShadowScorer`
(``quality.py``) scores a registry candidate on sampled live traffic.
The operator plane serves it all: :class:`ProgramInventory`
(``programz.py``: per program and per CUDA kernel, calls and launch work,
joined into ``round_end`` as the three-way cost line), the OpenMetrics
exporter and endpoints (``exporter.py``: :class:`OperatorPlane`) and
pod-scope stitching of per-rank streams (``podview.py``).
"""

from spark_ensemble_tpu_torch.telemetry.events import (
    PHASES_ENV,
    TELEMETRY_ENV,
    FitTelemetry,
    TelemetryRecorder,
    abort_active_fits,
    active_fit_depth,
    compile_snapshot,
    device_memory_stats,
    emit_event,
    global_metrics,
    note_compile,
    record_fits,
    serving_stream_id,
    telemetry_sink_active,
)
from spark_ensemble_tpu_torch.telemetry.exporter import (
    OperatorPlane,
    OperatorServer,
    render_openmetrics,
    start_operator_plane,
    validate_openmetrics,
    write_snapshot,
)
from spark_ensemble_tpu_torch.telemetry.flight import (
    FlightRecorder,
    dump_flight,
    flight_dump_path,
)
from spark_ensemble_tpu_torch.telemetry.podview import (
    estimate_offsets,
    skew_report,
    stitch,
    stitch_files,
)
from spark_ensemble_tpu_torch.telemetry.programz import (
    HbmSampler,
    ProgramInventory,
    ProgramRecord,
    global_inventory,
    xla_cost_fields,
)
from spark_ensemble_tpu_torch.telemetry.quality import (
    DriftMonitor,
    ShadowScorer,
    coarsen_counts,
    drift_reference_from_ctx,
    histogram_distribution,
    kl_divergence,
    prediction_divergence,
    psi,
    staged_attribution,
)
from spark_ensemble_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    MetricsRegistry,
    RoundTimer,
    StreamingHistogram,
)
from spark_ensemble_tpu_torch.telemetry.trace import (
    NULL_SPAN,
    NULL_TRACER,
    TRACE_ANNOTATIONS_ENV,
    Span,
    TraceContext,
    Tracer,
    new_flow_id,
    new_span_id,
    new_trace_id,
    trace_annotations_enabled,
)
from spark_ensemble_tpu_torch.telemetry.watchdog import (
    FALLBACK_THRESHOLDS,
    Rule,
    Watchdog,
    default_rules,
    probe_fleet_max,
    probe_gauge,
    probe_quality_max,
    sentinel_thresholds,
)

__all__ = [
    "FALLBACK_THRESHOLDS",
    "PHASES_ENV",
    "TELEMETRY_ENV",
    "TRACE_ANNOTATIONS_ENV",
    "Counter",
    "DriftMonitor",
    "FitTelemetry",
    "FlightRecorder",
    "Gauge",
    "HbmSampler",
    "MetricsRegistry",
    "NULL_SPAN",
    "NULL_TRACER",
    "OperatorPlane",
    "OperatorServer",
    "ProgramInventory",
    "ProgramRecord",
    "RoundTimer",
    "Rule",
    "ShadowScorer",
    "Span",
    "StreamingHistogram",
    "TelemetryRecorder",
    "TraceContext",
    "Tracer",
    "Watchdog",
    "abort_active_fits",
    "active_fit_depth",
    "coarsen_counts",
    "compile_snapshot",
    "default_rules",
    "device_memory_stats",
    "drift_reference_from_ctx",
    "dump_flight",
    "emit_event",
    "estimate_offsets",
    "flight_dump_path",
    "global_inventory",
    "global_metrics",
    "histogram_distribution",
    "kl_divergence",
    "new_flow_id",
    "new_span_id",
    "new_trace_id",
    "note_compile",
    "prediction_divergence",
    "probe_fleet_max",
    "probe_gauge",
    "probe_quality_max",
    "psi",
    "record_fits",
    "render_openmetrics",
    "sentinel_thresholds",
    "serving_stream_id",
    "skew_report",
    "staged_attribution",
    "start_operator_plane",
    "stitch",
    "stitch_files",
    "telemetry_sink_active",
    "trace_annotations_enabled",
    "validate_openmetrics",
    "write_snapshot",
    "xla_cost_fields",
]
