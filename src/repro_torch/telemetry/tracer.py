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
* ``traced`` -- a decorator wrapping a function in a span on the tracer
  active at each call; ``block=True`` waits for the CUDA tensors it
  returns before the clock stops.

An enabled tracer also gives, with no synchronisation inside a span:

* ``Tracer(device=True)`` -- each span records a CUDA event on the
  current stream at enter and at exit; ``resolve()`` synchronises once
  and fills ``SpanEvent.device_ts_us`` / ``device_dur_us`` on the
  tracer's host epoch (a reference event recorded, with one sync, when
  the tracer starts).  Without a card they stay ``None``.
* while ``torch.profiler`` records, each span is also a
  ``record_function`` range, so it lies on the profiler's clock beside
  the kernels it launched.
* ``span(..., allocator=device)`` -- on a CUDA device the span's
  ``allocator_calls`` (``cudaMalloc`` + ``cudaFree``) and
  ``alloc_retries``, the rise of the caching allocator's counts across it.
* ``count(name, n)`` -- adds ``n`` to the attribute ``name`` of every open
  span (``host_syncs`` at each site that blocks on the card).

Single-threaded by design, like the control plane it instruments.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.autograd.profiler import record_function

from .metrics import MetricsRegistry, NullMetricsRegistry

__all__ = ["NullTracer", "Span", "SpanEvent", "Tracer", "block_until_ready",
           "get_tracer", "set_tracer", "span", "stopwatch", "traced",
           "tracing"]


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


def _allocator_counts(device: torch.device) -> Tuple[int, int]:
    """(cudaMalloc + cudaFree calls, allocation retries) of the caching
    allocator on ``device`` so far."""
    st = torch.cuda.memory.memory_stats_as_nested_dict(device)
    return (st.get("num_device_alloc", 0) + st.get("num_device_free", 0),
            st.get("num_alloc_retries", 0))


@dataclasses.dataclass
class SpanEvent:
    """One completed span, times in microseconds since the tracer epoch.

    ``parent`` is the index in ``Tracer.events`` of the enclosing span's
    event (-1 at the top, and until the enclosing span has exited); the
    device interval is filled by ``Tracer.resolve`` on a device tracer."""
    name: str
    ts_us: float
    dur_us: float
    depth: int
    attrs: Dict[str, Any]
    parent: int = -1
    device_ts_us: Optional[float] = None
    device_dur_us: Optional[float] = None


class Span:
    """Context-manager handle of one timed region.

    ``block_on(x)`` designates ``x`` as an output the span must wait for;
    on exit, designated outputs are synchronised before the clock stops
    iff the span was created with ``block=True``.  ``set(**attrs)``
    attaches attributes; ``dur_s`` is available after exit.
    """

    __slots__ = ("_tracer", "name", "attrs", "_block", "_outs",
                 "_t0", "_t1", "depth", "_allocator", "_alloc0", "_range",
                 "_ev0", "_children")

    def __init__(self, tracer: Optional["Tracer"], name: str, block: bool,
                 attrs: Dict[str, Any], allocator=None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._block = block
        self._outs: List[Any] = []
        self._t0 = self._t1 = 0.0
        self.depth = 0
        self._allocator = allocator
        self._alloc0 = self._range = self._ev0 = None
        self._children: List[int] = []

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

    def span(self, name: str, *, block: bool = False, allocator=None,
             **attrs) -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str, n: int = 1) -> None:
        pass

    def resolve(self) -> List[SpanEvent]:
        return self.events

    def tick(self, step: int, **attrs) -> None:
        pass

    def traced(self, name: Optional[str] = None, *, block: bool = False,
               **attrs) -> Callable:
        return traced(name, block=block, **attrs)


class Tracer:
    """Collects ``SpanEvent``s and a ``MetricsRegistry`` for one run.

    Times are relative to the tracer's construction, in microseconds;
    ``tick(step)`` snapshots every registered counter and gauge.
    ``device=True`` times each span on the current CUDA stream as well
    (``resolve`` reads the times); without a card it records no event."""

    enabled = True

    def __init__(self, device: bool = False):
        self.events: List[SpanEvent] = []
        self._stack: List[Span] = []
        self.metrics = MetricsRegistry()
        # (event index, CUDA events at enter and exit) awaiting resolve()
        self._pending: List[Tuple[int, Any, Any]] = []
        self._stream = self._ref = None
        if device and torch.cuda.is_available():
            self._stream = torch.cuda.current_stream()
            self._ref = torch.cuda.Event(enable_timing=True)
            self._ref.record(self._stream)
            self._ref.synchronize()
        self._epoch = time.perf_counter()

    def _enter(self, sp: Span) -> int:
        depth = len(self._stack)
        self._stack.append(sp)
        if torch.autograd._profiler_enabled():
            sp._range = record_function(sp.name)
            sp._range.__enter__()
        dev = sp._allocator
        if dev is not None and torch.device(dev).type == "cuda":
            sp._alloc0 = _allocator_counts(dev)
        if self._ref is not None:
            sp._ev0 = torch.cuda.Event(enable_timing=True)
            sp._ev0.record(self._stream)
        return depth

    def _exit(self, sp: Span) -> None:
        if sp._ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(self._stream)
            self._pending.append((len(self.events), sp._ev0, ev1))
        if sp._alloc0 is not None:
            calls, retries = _allocator_counts(sp._allocator)
            sp.attrs["allocator_calls"] = calls - sp._alloc0[0]
            sp.attrs["alloc_retries"] = retries - sp._alloc0[1]
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        index = len(self.events)
        for child in sp._children:
            self.events[child].parent = index
        if self._stack:
            self._stack[-1]._children.append(index)
        self.events.append(SpanEvent(
            name=sp.name,
            ts_us=(sp._t0 - self._epoch) * 1e6,
            dur_us=sp.dur_s * 1e6,
            depth=sp.depth,
            attrs=sp.attrs))

    def span(self, name: str, *, block: bool = False, allocator=None,
             **attrs) -> Span:
        return Span(self, name, block, attrs, allocator)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the attribute ``name`` of every open span."""
        for sp in self._stack:
            sp.attrs[name] = sp.attrs.get(name, 0) + n

    def resolve(self) -> List[SpanEvent]:
        """Wait once for the card, then give each span recorded since the
        last call its device interval (the first event's completion to
        the second's, on the tracer's host epoch).  Returns ``events``."""
        if self._pending:
            # the reference event completed as the epoch was taken, so its
            # distance to an event is that event's time since the epoch;
            # both ends are read from it, so nested spans stay nested
            torch.cuda.synchronize(self._stream.device)
            for i, a, b in self._pending:
                start = self._ref.elapsed_time(a) * 1e3
                self.events[i].device_ts_us = start
                self.events[i].device_dur_us = (
                    self._ref.elapsed_time(b) * 1e3 - start)
            self._pending.clear()
        return self.events

    def now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def tick(self, step: int, **attrs) -> None:
        """Per-step counter snapshot (timestamped for counter tracks)."""
        self.metrics.tick(step, ts_us=self.now_us(), **attrs)

    def traced(self, name: Optional[str] = None, *, block: bool = False,
               **attrs) -> Callable:
        """Decorator twin of ``span`` bound to THIS tracer."""
        return traced(name, block=block, tracer=self, **attrs)


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


def span(name: str, *, block: bool = False, allocator=None, **attrs):
    """Span on the active tracer (shared no-op handle when telemetry is
    off -- safe in hot paths)."""
    return _ACTIVE.span(name, block=block, allocator=allocator, **attrs)


def stopwatch(name: str, *, block: bool = True, tracer=None, **attrs) -> Span:
    """Always-timing span: records into ``tracer`` (default: the active
    one) when enabled, but times -- and honours ``block`` -- regardless."""
    tr = tracer if tracer is not None else _ACTIVE
    return Span(tr if tr.enabled else None, name, block, attrs)


def traced(name: Optional[str] = None, *, block: bool = False, tracer=None,
           **attrs) -> Callable:
    """Decorator: wrap a function in a span on the active tracer.

    ``block=True`` designates the return value, so the span's clock stops
    only after the CUDA tensors it holds are computed
    (``block_until_ready``).  The tracer is resolved per *call* (late
    binding), so decorated library code follows ``tracing()`` scopes."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            tr = tracer if tracer is not None else _ACTIVE
            with tr.span(label, block=block, **attrs) as sp:
                out = fn(*args, **kw)
                if block:
                    sp.block_on(out)
            return out
        return wrapper
    return deco
