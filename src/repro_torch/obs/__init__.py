"""Observability of the port (counterpart of ``repro/obs``): tracing,
metrics, shadow quality scoring and SLOs.

The import surface is flat, as in the reference: instrumented modules do
``from repro_torch.obs import TRACER, metrics``.  This package imports
nothing from ``repro_torch.serve``/``tune``/``kernels`` (they import
it), and nothing of torch at import time.

Also here: the HTTP endpoint (:mod:`repro_torch.obs.server`:
``/metrics``, ``/healthz``, ``/varz``, ``/tracez``), the metrics report
(:mod:`repro_torch.obs.metrics_report`) and the single-process half of
the pod snapshots (:mod:`repro_torch.obs.pod`).  Still to be ported
(ROADMAP queue 1 item 9): ``pod_snapshot``'s all-gather across ranks
and the pod health ``/healthz`` reads from ``launch/multihost``.
"""
from .trace import (TRACER, Span, Tracer, disable_tracing, enable_tracing,
                    export_chrome_trace, get_tracer, merge_chrome_traces,
                    request_coverage, tracing_enabled)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry, note_static_fallback, warn_once)
from .quality import (CRITICAL, LEVELS, OK, SHADOW, WARN, AlertMachine,
                      ShadowScorer, get_shadow)
from .slo import MONITOR, SLO, SLOMonitor, get_monitor
from .server import ObsServer, validate_exposition
from .pod import (local_snapshot, merge_pod_trace, pod_quality_report,
                  pod_snapshot)

__all__ = [
    "TRACER", "Span", "Tracer", "enable_tracing", "disable_tracing",
    "tracing_enabled", "get_tracer", "export_chrome_trace",
    "merge_chrome_traces", "request_coverage",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "warn_once", "note_static_fallback",
    "SHADOW", "ShadowScorer", "AlertMachine", "get_shadow",
    "OK", "WARN", "CRITICAL", "LEVELS",
    "MONITOR", "SLO", "SLOMonitor", "get_monitor",
    "ObsServer", "validate_exposition",
    "local_snapshot", "pod_snapshot", "merge_pod_trace",
    "pod_quality_report",
]
