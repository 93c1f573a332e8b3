"""Spans, the counter registry and the trace exporters.  Counterpart of
``repro.telemetry``.

* ``Tracer`` -- nestable spans (``span(name, **attrs)``, the ``traced``
  decorator) with a ``block=`` option that waits for the CUDA work behind
  designated outputs (``block_until_ready``) before the clock stops.
* ``Counter`` / ``Gauge`` registry (``tracer.metrics``) for the paper's
  quality metrics, with per-step ``tick`` snapshots.
* Exporters: ``export_chrome_trace`` (Perfetto-loadable JSON; a
  multi-rank run merges the ranks' documents, each under its own pid,
  ``merge_chrome_traces``) and ``export_jsonl`` (a line-delimited event
  log), both schema-validated.
* ``NullTracer`` -- the process default; instrumented hot paths cost
  nothing when telemetry is off.

``Balancer``, ``AdaptiveSession`` and ``ServeSession`` publish through
the active tracer::

    from repro_torch import telemetry
    with telemetry.tracing() as tr:
        session.run()
    telemetry.export_chrome_trace(tr, "trace.json")
    telemetry.export_jsonl(tr, "counters.jsonl")
    print(tr.metrics.summary()["totals"])

``python -m repro_torch.telemetry.smoke --out DIR`` runs a sharded
adaptive session and a sharded serve trace over 4 ranks under tracing
and writes and validates both artifacts.
"""
from .metrics import (Counter, Gauge, MetricsRegistry,  # noqa: F401
                      NullMetricsRegistry)
from .tracer import (NullTracer, Span, SpanEvent, Tracer,  # noqa: F401
                     block_until_ready, get_tracer, set_tracer, span,
                     stopwatch, traced, tracing)
from .export import (JSONL_VERSION, SchemaError,  # noqa: F401
                     chrome_trace, export_chrome_trace, export_jsonl,
                     jsonl_events, merge_chrome_traces,
                     validate_chrome_trace, validate_jsonl,
                     write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "MetricsRegistry", "NullMetricsRegistry",
    "NullTracer", "Span", "SpanEvent", "Tracer",
    "get_tracer", "set_tracer", "span", "stopwatch", "traced", "tracing",
    "SchemaError", "chrome_trace", "export_chrome_trace", "export_jsonl",
    "jsonl_events", "validate_chrome_trace", "validate_jsonl",
    "capture",
    # the port's own
    "JSONL_VERSION", "block_until_ready", "merge_chrome_traces",
    "write_chrome_trace",
]


def capture(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a fresh tracer; return
    ``(result, summary)`` where ``summary`` is the metrics summary dict."""
    with tracing() as tr:
        result = fn(*args, **kwargs)
    return result, tr.metrics.summary()
