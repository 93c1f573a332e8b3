"""The port's telemetry exporters, ``traced``, ``capture`` and smoke
against the JAX package's: a traced host adaptive session exported by
the port passes the JAX package's validators and the port's own; both
reject the reference test's malformed documents; the JSONL totals line
equals the JAX package's for the same seeded session (integer counters
exactly, float ones within 1e-6); a multi-rank trace keeps each rank
under its own pid; and ``python -m repro_torch.telemetry.smoke --device
cpu`` (4 CPU ranks) exits 0 with valid artifacts."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import telemetry as jtelemetry
from repro.core import BalanceSpec as JBalanceSpec
from repro.fem import AdaptSpec as JAdaptSpec
from repro.fem import AdaptiveSession as JAdaptiveSession
from repro.fem import cylinder_mesh as j_cylinder_mesh
from repro.telemetry import export as jexport
from repro_torch import telemetry
from repro_torch.core import BalanceSpec
from repro_torch.fem import AdaptiveSession, AdaptSpec, cylinder_mesh
from repro_torch.telemetry import export as texport
from repro_torch.telemetry import smoke

ROOT = Path(__file__).resolve().parents[1]
FLOAT_TOL = 1e-6
SESSION = dict(problem="helmholtz", max_steps=2, max_tets=800,
               backend="host")


def _port_session():
    spec = AdaptSpec(**SESSION, balance=BalanceSpec(p=8, method="hsfc",
                                                    backend="host"))
    with telemetry.tracing() as tr:
        AdaptiveSession(spec, device="cpu").run(
            cylinder_mesh(4, 2, length=3.0, radius=0.5))
    return tr


@pytest.fixture(scope="module")
def traced():
    return _port_session()


def test_exports_pass_both_packages_validators(traced, tmp_path):
    doc = telemetry.export_chrome_trace(traced, str(tmp_path / "t.json"))
    loaded = json.loads((tmp_path / "t.json").read_text())
    assert loaded == json.loads(json.dumps(doc))
    assert loaded["otherData"]["producer"] == "repro_torch.telemetry"
    xs = [e for e in loaded["traceEvents"] if e["ph"] == "X"]
    assert {"adapt/step", "adapt/solve", "balance"} <= {e["name"]
                                                        for e in xs}
    assert {"imbalance", "cut"} <= {e["name"] for e in loaded["traceEvents"]
                                    if e["ph"] == "C"}
    jexport.validate_chrome_trace(loaded)
    texport.validate_chrome_trace(loaded)
    telemetry.export_jsonl(traced, str(tmp_path / "e.jsonl"))
    lines = [json.loads(x) for x in
             (tmp_path / "e.jsonl").read_text().splitlines()]
    assert lines[0] == {"type": "meta", "version": telemetry.JSONL_VERSION,
                        "producer": "repro_torch.telemetry"}
    jexport.validate_jsonl(lines)
    texport.validate_jsonl(lines)


def _span(**kw):
    return dict(ph="X", args={}, **kw)


#: the reference test's malformed documents (tests/test_telemetry.py)
BAD_TRACES = {
    "negative-dur": lambda doc: {"traceEvents": [
        dict(doc["traceEvents"][2], dur=-1.0)]},
    "no-traceEvents": lambda doc: {"events": []},
    "ts-backwards": lambda doc: {"traceEvents": [
        _span(name="a", ts=100.0, dur=1.0), _span(name="b", ts=5.0,
                                                  dur=1.0)]},
    "overlap-not-nested": lambda doc: {"traceEvents": [
        _span(name="a", ts=100.0, dur=1.0),
        _span(name="c", ts=100.5, dur=200.0)]},
}
BAD_LOGS = {"no-totals": lambda lines: lines[:-1],
            "no-meta": lambda lines: lines[1:]}


@pytest.mark.parametrize("case", list(BAD_TRACES) + list(BAD_LOGS))
def test_validators_reject_the_reference_tests_malformed_documents(
        traced, case):
    if case in BAD_TRACES:
        bad = BAD_TRACES[case](telemetry.chrome_trace(traced))
        checks = (texport.validate_chrome_trace, jexport.validate_chrome_trace)
    else:
        bad = BAD_LOGS[case](telemetry.jsonl_events(traced))
        checks = (texport.validate_jsonl, jexport.validate_jsonl)
    for check in checks:
        with pytest.raises(ValueError):
            check(bad)
    with pytest.raises(telemetry.SchemaError):
        checks[0](bad)


def test_jsonl_totals_equal_the_reference(traced):
    """The same seeded host session in both packages: the totals lines'
    keys equal, integer counters exactly, float ones within FLOAT_TOL."""
    spec = JAdaptSpec(**SESSION, balance=JBalanceSpec(p=8, method="hsfc",
                                                      backend="host"))
    with jtelemetry.tracing() as jtr:
        JAdaptiveSession(spec).run(j_cylinder_mesh(4, 2, length=3.0,
                                                   radius=0.5))
    got = telemetry.jsonl_events(traced)[-1]["metrics"]
    want = jtelemetry.jsonl_events(jtr)[-1]["metrics"]
    assert set(got) == set(want) and set(got["totals"]) == set(
        want["totals"])
    for name, w in want["totals"].items():
        g = got["totals"][name]
        if isinstance(w, int):
            assert isinstance(g, int) and g == w, name
        else:
            assert abs(g - w) <= FLOAT_TOL * max(1.0, abs(w)), name
    assert got["totals"]["repartitions"] > 0


def test_traced_decorator_late_binds_active_tracer(monkeypatch):
    """As the reference's test: the decorated function works with
    telemetry off and lands one span a call in the active tracer; with
    ``block=True`` the returned tensors are waited for before the span
    ends."""
    from repro_torch.telemetry import tracer as tracer_mod
    waited = []
    real = tracer_mod.block_until_ready
    monkeypatch.setattr(tracer_mod, "block_until_ready",
                        lambda x: waited.append(x) or real(x))

    @telemetry.traced("double", block=True)
    def double(x):
        return x * 2

    out = double(torch.arange(3))        # telemetry off: still works
    assert out.tolist() == [0, 2, 4] and waited == []
    with telemetry.tracing() as tr:
        out = double(torch.arange(3))
    assert [e.name for e in tr.events] == ["double"]
    assert len(waited) == 1 and waited[0][0] is out

    @telemetry.traced()
    def plain(x):
        return x + 1

    with telemetry.tracing() as tr:
        plain(torch.zeros(1))
    assert [e.name for e in tr.events] == [plain.__wrapped__.__qualname__]
    assert len(waited) == 1              # block=False never waits


def test_capture_returns_result_and_summary():
    def work(n):
        tr = telemetry.get_tracer()
        tr.metrics.counter("moved", unit="bytes").inc(n)
        return n * 2

    result, summary = telemetry.capture(work, 21)
    assert result == 42 and summary["totals"]["moved"] == 21
    assert not telemetry.get_tracer().enabled
    assert set(telemetry.__all__) >= set(jtelemetry.__all__)


def test_a_multi_rank_trace_keeps_each_rank_under_its_pid():
    """Two ranks' tracers whose spans overlap in time: the merged
    document keeps each under its own pid and validates (order and
    nesting hold within each track); within one track an overlap that
    does not nest is still refused."""
    docs = []
    for rank in range(2):
        tr = telemetry.Tracer()
        with tr.span("outer"):
            with tr.span("inner"):
                pass
        docs.append(telemetry.chrome_trace(tr, pid=rank))
    merged = telemetry.merge_chrome_traces(docs)
    texport.validate_chrome_trace(merged)
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    bad = {"traceEvents": [_span(name="a", ts=1.0, dur=5.0, pid=1, tid=0),
                           _span(name="b", ts=3.0, dur=5.0, pid=1, tid=0)]}
    with pytest.raises(telemetry.SchemaError):
        texport.validate_chrome_trace(bad)


def test_smoke_on_four_cpu_ranks_exits_zero(tmp_path):
    """``python -m repro_torch.telemetry.smoke --device cpu``: exit 0; the
    trace holds every rank's spans under its pid and passes the port's
    validator; the event log passes both packages'; every required span
    is on every rank, every required counter in rank 0's totals."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.smoke", "--device",
         "cpu", "--out", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "telemetry smoke OK" in out.stdout
    doc = json.loads((tmp_path / "trace.json").read_text())
    texport.validate_chrome_trace(doc)
    spans = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            spans.setdefault(e["pid"], set()).add(e["name"])
    assert sorted(spans) == [0, 1, 2, 3]
    assert all(smoke.REQUIRED_SPANS <= s for s in spans.values())
    lines = [json.loads(x) for x in
             (tmp_path / "counters.jsonl").read_text().splitlines()]
    jexport.validate_jsonl(lines)
    totals = lines[-1]["metrics"]["totals"]
    assert smoke.REQUIRED_COUNTERS <= set(totals)
    assert totals["moved_kv_bytes"] > 0 and totals["comm_halo_bytes"] > 0
    assert np.isfinite(totals["imbalance"])
