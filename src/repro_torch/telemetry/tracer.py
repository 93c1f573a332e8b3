"""Span tracer: nestable timed regions with clocks that wait for the card.

PyTorch returns from a CUDA call as soon as the work is *enqueued*, so a
``perf_counter`` pair around it times the launch, not the work.  Every
span therefore carries a ``block`` option: outputs designated with
``Span.block_on`` are waited for --
``torch.cuda.synchronize`` on each CUDA device they live on -- before the
clock stops, so a span covers the device work it launched.

* ``Tracer.span`` / ``span`` -- records a ``SpanEvent`` into the active
  tracer; with the ``NullTracer`` (telemetry off) it is a shared no-op.
* ``stopwatch`` -- always times and always honours ``block``, recording
  into the tracer only when one is active (``Balancer.balance_timed``
  and the adaptive session's ``StepStats`` consume its duration).

Single-threaded by design, like the control plane it instruments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Set

import torch

from .metrics import MetricsRegistry, NullMetricsRegistry

__all__ = ["NullTracer", "Span", "SpanEvent", "Tracer", "block_until_ready",
           "get_tracer", "set_tracer", "span", "stopwatch", "tracing"]


def _cuda_devices(value: Any, out: Set[torch.device]) -> None:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)


def block_until_ready(value: Any) -> Any:
    """Wait for the device work behind ``value``: tensors, or lists,
    tuples, dicts and dataclasses holding them.  Returns ``value``."""
    devices: Set[torch.device] = set()
    _cuda_devices(value, devices)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return value


@dataclasses.dataclass
class SpanEvent:
    """One completed span, times in microseconds since the tracer epoch."""
    name: str
    ts_us: float
    dur_us: float
    depth: int
    attrs: Dict[str, Any]


class Span:
    """Context-manager handle of one timed region.

    ``block_on(x)`` designates ``x`` as an output the span must wait for;
    on exit, designated outputs are synchronised before the clock stops
    iff the span was created with ``block=True``.  ``set(**attrs)``
    attaches attributes; ``dur_s`` is available after exit.
    """

    __slots__ = ("_tracer", "name", "attrs", "_block", "_outs",
                 "_t0", "_t1", "depth")

    def __init__(self, tracer: Optional["Tracer"], name: str, block: bool,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._block = block
        self._outs: List[Any] = []
        self._t0 = self._t1 = 0.0
        self.depth = 0

    def block_on(self, value):
        """Designate ``value`` as an output to wait for before the clock
        stops (returns it unchanged, so it composes inline)."""
        self._outs.append(value)
        return value

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        if self._tracer is not None:
            self.depth = self._tracer._enter(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._block and self._outs:
            block_until_ready(self._outs)
        self._t1 = time.perf_counter()
        if self._tracer is not None:
            self._tracer._exit(self)
        return False

    @property
    def dur_s(self) -> float:
        """Blocking wall-clock duration in seconds (after exit)."""
        return self._t1 - self._t0


class _NullSpan:
    """Shared no-op span handle: the telemetry-off fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def block_on(self, value):
        return value

    def set(self, **attrs) -> "_NullSpan":
        return self

    @property
    def dur_s(self) -> float:
        return 0.0


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Telemetry off: same surface as ``Tracer``, does nothing."""

    enabled = False

    def __init__(self):
        self.metrics = NullMetricsRegistry()
        self.events: List[SpanEvent] = []

    def span(self, name: str, *, block: bool = False, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def tick(self, step: int, **attrs) -> None:
        pass


class Tracer:
    """Collects ``SpanEvent``s and a ``MetricsRegistry`` for one run.

    Times are relative to the tracer's construction, in microseconds;
    ``tick(step)`` snapshots every registered counter and gauge."""

    enabled = True

    def __init__(self):
        self._epoch = time.perf_counter()
        self.events: List[SpanEvent] = []
        self._stack: List[Span] = []
        self.metrics = MetricsRegistry()

    def _enter(self, sp: Span) -> int:
        depth = len(self._stack)
        self._stack.append(sp)
        return depth

    def _exit(self, sp: Span) -> None:
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        self.events.append(SpanEvent(
            name=sp.name,
            ts_us=(sp._t0 - self._epoch) * 1e6,
            dur_us=sp.dur_s * 1e6,
            depth=sp.depth,
            attrs=sp.attrs))

    def span(self, name: str, *, block: bool = False, **attrs) -> Span:
        return Span(self, name, block, attrs)

    def now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def tick(self, step: int, **attrs) -> None:
        """Per-step counter snapshot (timestamped for counter tracks)."""
        self.metrics.tick(step, ts_us=self.now_us(), **attrs)


_ACTIVE: Any = NullTracer()


def get_tracer():
    """The process-wide active tracer (a ``NullTracer`` unless installed)."""
    return _ACTIVE


def set_tracer(tracer):
    """Install ``tracer`` as the active one; returns the previous."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer if tracer is not None else NullTracer()
    return prev


class tracing:
    """``with tracing() as tr:`` -- install a (new) tracer for a scope."""

    def __init__(self, tracer: Optional[Tracer] = None):
        self.tracer = tracer if tracer is not None else Tracer()
        self._prev = None

    def __enter__(self) -> Tracer:
        self._prev = set_tracer(self.tracer)
        return self.tracer

    def __exit__(self, exc_type, exc, tb) -> bool:
        set_tracer(self._prev)
        return False


def span(name: str, *, block: bool = False, **attrs):
    """Span on the active tracer (shared no-op handle when telemetry is
    off -- safe in hot paths)."""
    return _ACTIVE.span(name, block=block, **attrs)


def stopwatch(name: str, *, block: bool = True, tracer=None, **attrs) -> Span:
    """Always-timing span: records into ``tracer`` (default: the active
    one) when enabled, but times -- and honours ``block`` -- regardless."""
    tr = tracer if tracer is not None else _ACTIVE
    return Span(tr if tr.enabled else None, name, block, attrs)
