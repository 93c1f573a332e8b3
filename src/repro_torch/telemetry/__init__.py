"""Spans and the counter registry (``repro.telemetry``'s tracer and
metrics; the Chrome-trace / JSONL exporters are not ported yet).

``Balancer`` and ``AdaptiveSession`` publish through the active tracer::

    from repro_torch import telemetry
    with telemetry.tracing() as tr:
        session.run()
    print(tr.metrics.summary()["totals"])
"""
from .metrics import (Counter, Gauge, MetricsRegistry,  # noqa: F401
                      NullMetricsRegistry)
from .tracer import (NullTracer, Span, SpanEvent, Tracer,  # noqa: F401
                     block_until_ready, get_tracer, set_tracer, span,
                     stopwatch, tracing)

__all__ = [
    "Counter", "Gauge", "MetricsRegistry", "NullMetricsRegistry",
    "NullTracer", "Span", "SpanEvent", "Tracer", "block_until_ready",
    "get_tracer", "set_tracer", "span", "stopwatch", "tracing",
]
