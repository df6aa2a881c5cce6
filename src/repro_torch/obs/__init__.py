"""Observability: structured tracing, typed metrics, machine-readable reports
(port of ``repro.obs``).

  * :mod:`repro_torch.obs.trace`   -- nested span tracer (context-manager API,
    host wall clock, opt-in device-time scoping by one
    ``torch.cuda.synchronize()`` at span close) exporting Chrome/Perfetto
    ``trace_event`` JSON;
  * :mod:`repro_torch.obs.metrics` -- typed registry of counters, gauges and
    fixed-boundary histograms (p50/p95/p99 without sample storage), plus the
    canonical job-counter glossary and merge/normalization policy;
  * :mod:`repro_torch.obs.report`  -- JSONL sink, human-readable summary
    table, environment metadata stamp, and the trace/metrics validators.

Disabled, both the tracer and the registry are shared null singletons: the
hot paths see no allocation and no added device sync.
"""
from .metrics import (COUNTER_DOC, MetricsRegistry, get_registry,
                      merge_counter_dicts, normalize_counters, null_registry,
                      set_registry)
from .trace import NULL_SPAN, Tracer, disable_tracing, enable_tracing, \
    get_tracer, span, span_coverage
from .report import (environment_metadata, setup, summary_table,
                     validate_metrics, validate_trace, write_jsonl)

__all__ = [
    "COUNTER_DOC", "MetricsRegistry", "get_registry", "merge_counter_dicts",
    "normalize_counters", "null_registry", "set_registry",
    "NULL_SPAN", "Tracer", "disable_tracing", "enable_tracing", "get_tracer",
    "span", "span_coverage",
    "environment_metadata", "setup", "summary_table", "validate_metrics",
    "validate_trace", "write_jsonl",
]
