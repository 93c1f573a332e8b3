"""The DLB step's spans and counts (``Balancer.balance`` under a tracer,
on the CPU): the span tree of a k-section balance with old parts, the
host-sync count against the rounds, the same result with tracing on and
off, the spans on the profiler's clock only while tracing is on, the
device fields of a device tracer without a card, the allocator counts,
and the device track of the Chrome trace."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.core import Balancer, BalanceSpec
from repro_torch.telemetry import export as texport
from repro_torch.telemetry import tracer as tracer_mod

N, P = 6000, 16
STAGES = ("balance/keys", "balance/partition1d", "balance/remap",
          "balance/migrate", "balance/part_weights")


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(N, 3, generator=g)
    w = torch.randint(1, 5, (N,), generator=g).float()
    w2 = torch.where(torch.rand(N, generator=g) < 0.2, 2 * w, w)
    return xyz, w, w2


def _balance(tracer, *, warm=False, iters=12, seed=0):
    """A first balance untraced, then one with old parts under ``tracer``
    (None: untraced too)."""
    xyz, w, w2 = _inputs(seed)
    spec = BalanceSpec(p=P, method="hsfc", oneD="ksection", iters=iters,
                       warm_start=warm)
    bal = Balancer(spec, "cpu")
    first = bal.balance(w, coords=xyz)
    if tracer is None:
        return bal.balance(w2, coords=xyz, old_parts=first.parts)
    with telemetry.tracing(tracer):
        return bal.balance(w2, coords=xyz, old_parts=first.parts)


def _tree(tr):
    return [(e.name, tr.events[e.parent].name if e.parent >= 0 else None)
            for e in tr.events]


@pytest.mark.parametrize("warm", [False, True])
def test_span_tree_of_a_ksection_balance_with_old_parts(warm):
    tr = telemetry.Tracer()
    res = _balance(tr, warm=warm)
    tree = _tree(tr)
    assert tree[-1] == ("balance", None)
    assert [n for n, parent in tree if parent == "balance"] == list(STAGES)
    rounds = [e for e in tr.events if e.name == "ksection/round"]
    assert [e.attrs["round"] for e in rounds] == list(range(
        res.ksection_rounds))
    parents = {n: {p for m, p in tree if m == n} for n, _ in tree}
    assert parents["ksection/round"] == {"balance/partition1d"}
    assert parents["ksection/assign"] == {"balance/partition1d"}
    assert parents["ksection/sync"] == {"balance/partition1d"}
    assert parents["remap/similarity"] == parents["remap/greedy"] == {
        "balance/remap"}
    assert ("ksection/warm_start" in parents) == warm
    # a check before each round, and the one that stops the loop
    inside = [n for n, p in tree if p == "balance/partition1d"]
    checks = [i for i, n in enumerate(inside) if n == "ksection/sync"]
    assert [inside[i + 1] for i in checks[:-1]] == ["ksection/round"] * (
        len(checks) - 1)
    assert len(checks) == res.ksection_rounds + 1
    for e in tr.events:
        assert e.depth == (0 if e.parent < 0
                           else tr.events[e.parent].depth + 1)


@pytest.mark.parametrize("iters", [12, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_host_syncs_are_one_a_round_and_the_check_that_stops(iters, warm):
    tr = telemetry.Tracer()
    res = _balance(tr, warm=warm, iters=iters)
    rounds = res.ksection_rounds
    assert 0 < rounds <= iters
    want = rounds + (rounds < iters) + warm
    top = {e.name: e for e in tr.events if e.depth <= 1}
    assert top["balance"].attrs["host_syncs"] == want
    assert top["balance/partition1d"].attrs["host_syncs"] == want
    assert all("host_syncs" not in top[s].attrs
               for s in STAGES if s != "balance/partition1d")
    assert sum(e.name == "ksection/sync" for e in tr.events) == (
        rounds + (rounds < iters))


def test_the_result_is_the_same_with_tracing_on_and_off():
    on = _balance(telemetry.Tracer(device=True), warm=True)
    off = _balance(None, warm=True)
    for f in dataclasses.fields(on):
        a, b = getattr(on, f.name), getattr(off, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def _profiled(tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _balance(tracer)
    return prof.events()


def test_without_tracing_the_profiler_sees_no_span():
    names = {e.name for e in _profiled(None)}
    assert not any(n.startswith(("balance", "ksection/", "remap/"))
                   for n in names)


def test_with_tracing_the_keys_span_holds_the_keys_stage_ops():
    events = _profiled(telemetry.Tracer())
    keys = [e for e in events if e.name == "balance/keys"]
    assert len(keys) == 1
    s, t = keys[0].time_range.start, keys[0].time_range.end
    inside = {e.name for e in events
              if s <= e.time_range.start and e.time_range.end <= t}
    # bounding_box and box_map
    assert {"aten::amin", "aten::amax", "aten::floor"} <= inside
    assert {"balance", "balance/partition1d", "ksection/round"} <= {
        e.name for e in events}


def test_a_device_tracer_without_a_card_leaves_the_device_fields_none():
    tr = telemetry.Tracer(device=True)
    _balance(tr)
    assert tr.resolve() is tr.events and tr.events
    for e in tr.events:
        assert e.device_ts_us is None and e.device_dur_us is None
        assert "allocator_calls" not in e.attrs


def test_allocator_counts_are_the_rise_across_the_span(monkeypatch):
    reads = iter([(10, 0), (12, 0), (17, 1), (30, 1)])
    monkeypatch.setattr(tracer_mod, "_allocator_counts",
                        lambda dev: next(reads))
    tr = telemetry.Tracer()
    cuda = torch.device("cuda", 0)
    with tr.span("outer", allocator=cuda):
        with tr.span("inner", allocator=cuda):
            pass
    inner, outer = tr.events
    assert (inner.attrs["allocator_calls"], inner.attrs["alloc_retries"]) == (
        5, 1)
    assert (outer.attrs["allocator_calls"], outer.attrs["alloc_retries"]) == (
        20, 1)
    # on the CPU, and with telemetry off, the allocator is never read
    monkeypatch.setattr(tracer_mod, "_allocator_counts",
                        lambda dev: pytest.fail("read the allocator"))
    with tr.span("cpu", allocator=torch.device("cpu")):
        pass
    with telemetry.span("off", allocator=cuda):
        pass
    assert "allocator_calls" not in tr.events[-1].attrs


def test_counts_go_to_every_open_span_and_nowhere_with_tracing_off():
    tr = telemetry.Tracer()
    with tr.span("a"):
        with tr.span("b"):
            tr.count("host_syncs")
        tr.count("host_syncs", 2)
    b, a = tr.events
    assert b.attrs == {"host_syncs": 1} and a.attrs == {"host_syncs": 3}
    assert b.parent == 1 and a.parent == -1
    telemetry.get_tracer().count("host_syncs")
    assert telemetry.get_tracer().events == []


def test_chrome_trace_writes_device_intervals_on_their_own_track():
    tr = telemetry.Tracer()
    with tr.span("outer", step=1):
        with tr.span("inner"):
            pass
        with tr.span("host_only"):
            pass
    inner, host_only, outer = tr.events
    outer.device_ts_us, outer.device_dur_us = 500.0, 90.0
    inner.device_ts_us, inner.device_dur_us = 510.0, 80.0
    doc = telemetry.chrome_trace(tr, pid=3)
    texport.validate_chrome_trace(doc)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    host = [e for e in xs if e["tid"] == 0]
    dev = [e for e in xs if e["tid"] == 1]
    assert [e["name"] for e in host] == ["outer", "inner", "host_only"]
    assert [(e["name"], e["ts"], e["dur"]) for e in dev] == [
        ("outer", 500.0, 90.0), ("inner", 510.0, 80.0)]
    assert {e["name"]: e["args"]["parent"] for e in host} == {
        "outer": -1, "inner": 2, "host_only": 2}
    assert dev[0]["args"] == {"step": 1, "parent": -1}
    assert {"name": "device"} in [e["args"] for e in doc["traceEvents"]
                                  if e["ph"] == "M"]
    # the device track's nesting is checked on its own
    inner.device_dur_us = 200.0
    with pytest.raises(telemetry.SchemaError):
        texport.validate_chrome_trace(telemetry.chrome_trace(tr))
    # without device intervals no device track
    plain = telemetry.Tracer()
    with plain.span("x"):
        pass
    assert {e["tid"] for e in telemetry.chrome_trace(plain)[
        "traceEvents"]} == {0}
