"""Typed Counter/Gauge registry with per-step snapshots.

The registry holds the paper's quality metrics — imbalance, cut,
migration volume/retained, halo/psum wire bytes, moved KV bytes — as
named instruments.  ``counter(name)`` / ``gauge(name)`` are
get-or-create and *typed*: asking for an existing name with the other
kind raises, so two call sites can't silently disagree about a metric's
semantics.

``tick(step)`` appends a snapshot row of every instrument's current
value; exporters turn those rows into Chrome-trace counter tracks and
JSONL ``counters`` lines.  ``summary()`` gives the final totals that
benchmarks merge into their JSON records.

Values are plain Python numbers: publishers convert device arrays with
``float()``/``int()`` at the boundary (they are tiny scalars, and doing
it here keeps exports JSON-clean and bit-stable across backends).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Gauge", "MetricsRegistry", "NullMetricsRegistry"]


class Counter:
    """Monotonically accumulating metric (volumes, byte totals)."""

    kind = "counter"
    __slots__ = ("name", "unit", "help", "value")

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name = name
        self.unit = unit
        self.help = help
        self.value = 0

    def inc(self, v=1) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name!r}: negative inc {v!r}")
        self.value = self.value + v


class Gauge:
    """Point-in-time metric (imbalance, cut, per-step bytes)."""

    kind = "gauge"
    __slots__ = ("name", "unit", "help", "value")

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name = name
        self.unit = unit
        self.help = help
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class MetricsRegistry:
    """Named, typed instruments plus the per-step snapshot log."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self.ticks: List[Dict[str, Any]] = []

    def _get(self, cls, name: str, unit: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, unit=unit, help=help)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, unit: str = "", help: str = "") -> Counter:
        return self._get(Counter, name, unit, help)

    def gauge(self, name: str, unit: str = "", help: str = "") -> Gauge:
        return self._get(Gauge, name, unit, help)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """Current value of every instrument, sorted by name."""
        return {name: self._metrics[name].value
                for name in sorted(self._metrics)}

    def tick(self, step: int, ts_us: Optional[float] = None, **attrs) -> None:
        row = {"step": step, "values": self.snapshot()}
        if ts_us is not None:
            row["ts_us"] = ts_us
        if attrs:
            row["attrs"] = attrs
        self.ticks.append(row)

    def summary(self) -> Dict[str, Any]:
        """Final totals + instrument metadata (for benchmark JSON)."""
        return {
            "totals": self.snapshot(),
            "meta": {name: {"kind": m.kind, "unit": m.unit, "help": m.help}
                     for name, m in sorted(self._metrics.items())},
            "n_ticks": len(self.ticks),
        }


class _NullMetric:
    """Accepts updates, keeps nothing."""

    kind = "null"
    __slots__ = ()
    name = unit = help = ""
    value = 0

    def inc(self, v=1) -> None:
        pass

    def set(self, v) -> None:
        pass


_NULL_METRIC = _NullMetric()


class NullMetricsRegistry:
    """Telemetry-off registry: every instrument is the shared no-op."""

    def __init__(self):
        self.ticks: List[Dict[str, Any]] = []

    def counter(self, name: str, unit: str = "", help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, unit: str = "", help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def names(self) -> List[str]:
        return []

    def snapshot(self) -> Dict[str, Any]:
        return {}

    def tick(self, step: int, ts_us: Optional[float] = None, **attrs) -> None:
        pass

    def summary(self) -> Dict[str, Any]:
        return {"totals": {}, "meta": {}, "n_ticks": 0}
