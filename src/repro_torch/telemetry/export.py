"""Exporters: Chrome-trace (Perfetto-loadable) JSON and a JSONL event log.
Counterpart of ``repro/telemetry/export.py``.

Both formats are produced from the same ``Tracer`` and validated before
they are written, by hand-rolled schema checks (types, required keys,
non-negative durations, monotonic timestamps, and proper span nesting).
A multi-rank run puts each rank's spans under its own ``pid``
(``chrome_trace(tracer, pid=rank)``, merged by ``merge_chrome_traces``):
the checks of order and nesting hold within each ``(pid, tid)`` track,
since the ranks' clocks run side by side.

Chrome-trace: ``{"traceEvents": [...]}`` with ``"ph": "X"`` complete
events for spans (ts/dur in microseconds, the enclosing span's event
index as ``args.parent``), ``"ph": "C"`` counter events per metric per
tick, and ``"ph": "M"`` process/thread metadata — load the file at
https://ui.perfetto.dev or chrome://tracing.  Spans a device tracer
timed on the card (``Tracer.resolve``) appear a second time, at their
device interval, on a ``device`` thread track of the same pid.

JSONL: one self-describing JSON object per line — a ``meta`` header,
one ``span`` line per completed span, one ``counters`` line per tick,
and a final timestamp-free ``totals`` line (so repeated seeded runs
produce bit-identical totals lines even though span timings differ).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

__all__ = ["SchemaError", "chrome_trace", "export_chrome_trace",
           "export_jsonl", "jsonl_events", "merge_chrome_traces",
           "validate_chrome_trace", "validate_jsonl", "write_chrome_trace"]

PRODUCER = "repro_torch.telemetry"

JSONL_VERSION = 1


class SchemaError(ValueError):
    """An export document violates its schema."""


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


# ---------------------------------------------------------------------------
# Chrome trace
# ---------------------------------------------------------------------------

def chrome_trace(tracer, *, pid: int = 0, tid: int = 0) -> Dict[str, Any]:
    """Build a Chrome-trace document from ``tracer`` (spans + counters),
    its events under ``pid`` / ``tid`` (a rank's own pid in a multi-rank
    trace); device intervals, where there are any, under ``tid + 1``."""
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": tid,
         "args": {"name": "repro_torch"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "args": {"name": "control"}},
    ]
    # spans were appended at exit (children before parents); re-sort by
    # start time so ts is monotonic as chrome://tracing expects
    for ev in sorted(tracer.events, key=lambda e: (e.ts_us, -e.dur_us)):
        events.append({
            "ph": "X", "name": ev.name, "cat": "span",
            "ts": ev.ts_us, "dur": ev.dur_us,
            "pid": pid, "tid": tid,
            "args": dict(ev.attrs, parent=ev.parent),
        })
    on_device = sorted((e for e in tracer.events
                        if e.device_ts_us is not None),
                       key=lambda e: (e.device_ts_us, -e.device_dur_us))
    if on_device:
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid + 1, "args": {"name": "device"}})
    for ev in on_device:
        events.append({
            "ph": "X", "name": ev.name, "cat": "span.device",
            "ts": ev.device_ts_us, "dur": ev.device_dur_us,
            "pid": pid, "tid": tid + 1,
            "args": dict(ev.attrs, parent=ev.parent),
        })
    for row in tracer.metrics.ticks:
        ts = row.get("ts_us", 0.0)
        for name, value in row["values"].items():
            events.append({
                "ph": "C", "name": name, "cat": "metric",
                "ts": ts, "pid": pid, "tid": tid,
                "args": {name: value},
            })
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": PRODUCER}}


def merge_chrome_traces(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One document of several ``chrome_trace`` documents (the ranks', each
    under its own pid): their events in order."""
    return {"traceEvents": [ev for doc in docs for ev in doc["traceEvents"]],
            "displayTimeUnit": "ms", "otherData": {"producer": PRODUCER}}


def validate_chrome_trace(doc: Any) -> None:
    """Raise ``SchemaError`` unless ``doc`` is a well-formed trace:
    required keys per phase, numeric non-negative ts/dur, ts monotonic
    over the X events of each (pid, tid) track, and those properly
    nested (a later span starting inside an open one must also end
    inside it)."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise SchemaError("top level must be an object with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise SchemaError("'traceEvents' must be a list")
    # per track: [previous span ts, (start, end) of enclosing X spans]
    tracks: Dict[tuple, list] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise SchemaError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "C", "M"):
            raise SchemaError(f"event {i}: unknown ph {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise SchemaError(f"event {i}: missing/empty name")
        if ph == "M":
            continue
        if not _num(ev.get("ts")) or ev["ts"] < 0:
            raise SchemaError(f"event {i}: bad ts {ev.get('ts')!r}")
        if not isinstance(ev.get("args", {}), dict):
            raise SchemaError(f"event {i}: args must be an object")
        if ph == "C":
            for v in ev.get("args", {}).values():
                if not _num(v):
                    raise SchemaError(
                        f"event {i}: counter value {v!r} not numeric")
            continue
        # ph == "X"
        if not _num(ev.get("dur")) or ev["dur"] < 0:
            raise SchemaError(f"event {i}: bad dur {ev.get('dur')!r}")
        ts, end = ev["ts"], ev["ts"] + ev["dur"]
        track = tracks.setdefault((ev.get("pid"), ev.get("tid")), [None, []])
        prev_ts, open_stack = track
        if prev_ts is not None and ts < prev_ts:
            raise SchemaError(
                f"event {i}: ts {ts} < previous span ts {prev_ts}")
        track[0] = ts
        while open_stack and ts >= open_stack[-1][1]:
            open_stack.pop()
        if open_stack and end > open_stack[-1][1]:
            raise SchemaError(
                f"event {i}: span [{ts}, {end}] overlaps but is not "
                f"nested in enclosing span ending at {open_stack[-1][1]}")
        open_stack.append((ts, end))


def export_chrome_trace(tracer, path: str) -> Dict[str, Any]:
    """Validate and write the Chrome-trace JSON; returns the document."""
    return write_chrome_trace(chrome_trace(tracer), path)


def write_chrome_trace(doc: Dict[str, Any], path: str) -> Dict[str, Any]:
    """Validate and write a Chrome-trace document (``chrome_trace``'s, or
    ``merge_chrome_traces``' of several ranks'); returns it."""
    validate_chrome_trace(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------

def jsonl_events(tracer) -> List[Dict[str, Any]]:
    """Build the JSONL line objects (meta, spans, counters, totals)."""
    lines: List[Dict[str, Any]] = [
        {"type": "meta", "version": JSONL_VERSION,
         "producer": PRODUCER},
    ]
    for ev in sorted(tracer.events, key=lambda e: (e.ts_us, -e.dur_us)):
        lines.append({"type": "span", "name": ev.name,
                      "ts_us": ev.ts_us, "dur_us": ev.dur_us,
                      "depth": ev.depth, "attrs": dict(ev.attrs)})
    for row in tracer.metrics.ticks:
        line = {"type": "counters", "step": row["step"],
                "values": dict(row["values"])}
        if "ts_us" in row:
            line["ts_us"] = row["ts_us"]
        lines.append(line)
    # timestamp-free by design: two seeded runs must produce
    # byte-identical totals lines
    lines.append({"type": "totals", "metrics": tracer.metrics.summary()})
    return lines


def validate_jsonl(lines: List[Dict[str, Any]]) -> None:
    """Raise ``SchemaError`` unless ``lines`` is a well-formed event log:
    meta header first, exactly one trailing totals line, typed span and
    counters lines in between."""
    if not lines:
        raise SchemaError("empty event log")
    if lines[0].get("type") != "meta" or \
            lines[0].get("version") != JSONL_VERSION:
        raise SchemaError("first line must be a versioned meta header")
    if lines[-1].get("type") != "totals":
        raise SchemaError("last line must be a totals line")
    n_totals = 0
    for i, line in enumerate(lines):
        if not isinstance(line, dict):
            raise SchemaError(f"line {i}: not an object")
        t = line.get("type")
        if t == "meta":
            if i != 0:
                raise SchemaError(f"line {i}: meta must be first")
        elif t == "span":
            if not isinstance(line.get("name"), str) or not line["name"]:
                raise SchemaError(f"line {i}: span missing name")
            if not _num(line.get("ts_us")) or line["ts_us"] < 0:
                raise SchemaError(f"line {i}: bad ts_us")
            if not _num(line.get("dur_us")) or line["dur_us"] < 0:
                raise SchemaError(f"line {i}: bad dur_us")
            if not isinstance(line.get("depth"), int) or line["depth"] < 0:
                raise SchemaError(f"line {i}: bad depth")
        elif t == "counters":
            if not isinstance(line.get("step"), int):
                raise SchemaError(f"line {i}: counters missing step")
            values = line.get("values")
            if not isinstance(values, dict):
                raise SchemaError(f"line {i}: counters missing values")
            for k, v in values.items():
                if not _num(v):
                    raise SchemaError(
                        f"line {i}: counter {k!r} value {v!r} not numeric")
        elif t == "totals":
            n_totals += 1
            m = line.get("metrics")
            if not isinstance(m, dict) or "totals" not in m:
                raise SchemaError(f"line {i}: malformed totals")
        else:
            raise SchemaError(f"line {i}: unknown type {t!r}")
    if n_totals != 1:
        raise SchemaError(f"expected exactly 1 totals line, got {n_totals}")


def export_jsonl(tracer, path: str) -> List[Dict[str, Any]]:
    """Validate and write the JSONL event log; returns the line objects."""
    lines = jsonl_events(tracer)
    validate_jsonl(lines)
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line, sort_keys=True) + "\n")
    return lines
