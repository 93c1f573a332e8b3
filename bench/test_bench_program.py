"""CPU tests of the readers of the program's own spans and counts
(``bench.program``): a traced run reads every host stage span and the
sync count and no device metric, a program without a device tracer
gives nothing to read, and the summaries of known spans and of a known
profiler timeline."""
import types

import pytest

from bench import harness, program

BENCH = harness.load_benchmark()
NEW = ("stage_host_ms", "stage_device_ms", "host_syncs_per_repartition",
       "allocator_calls_per_repartition")


def _new_metrics(workload):
    return [m["name"] for m in harness.metrics_of(BENCH, workload, True)
            if m["name"].startswith(NEW)]


def _trace_run(workload):
    cell = harness.find_cell(BENCH, workload)
    cell["config"]["n"], cell["config"]["spec"]["p"] = 4096, 16
    return harness.run_cell(cell, 2 ** 31 + 11, 0.05, True, "cpu", 0.0,
                            metrics=harness.metrics_of(BENCH, workload,
                                                       True))


@pytest.mark.parametrize("workload", ["ex32_moving_peak", "ex31_initial"])
def test_cpu_trace_run_reads_host_spans_and_syncs_and_no_device_metric(
        workload):
    out = _trace_run(workload)
    m = out["metrics"]
    host = [n for n in _new_metrics(workload)
            if n.startswith(("stage_host_ms", "host_syncs"))]
    assert len(host) == (6 if workload == "ex32_moving_peak" else 4)
    for name in host:
        assert m[name]["value"] > 0, name
    # no card: nothing on the device's clock, no allocator
    assert not [n for n in m if n.startswith(("stage_device_ms",
                                              "allocator_calls"))]
    # the old readers read as before, and checks stays last
    assert m[f"stage_ms.keys.{workload}"]["value"] > 0
    assert list(out)[-1] == "checks" and out["correct"]
    syncs = m[f"host_syncs_per_repartition.{workload}"]["value"]
    rounds = m[f"ksection_rounds.{workload}"]["value"]
    # a sync a round, one for the check that stops, one for a warm start
    assert rounds <= syncs <= rounds + 2


def test_a_program_without_a_device_tracer_gives_nothing(monkeypatch):
    from repro_torch import telemetry

    class OldTracer:
        """The tracer as it was before device mode."""
        enabled = True

        def __init__(self):
            raise AssertionError("not to be made")
    monkeypatch.setattr(telemetry, "Tracer", OldTracer)
    out = _trace_run("ex31_initial")
    assert not [n for n in out["metrics"] if n.startswith(NEW)]
    assert out["metrics"]["stage_ms.keys.ex31_initial"]["value"] > 0


def test_readers_outside_a_run_read_nothing():
    ctx = {}
    for name in _new_metrics("ex31_steady"):
        assert harness.reader(name)(ctx) is None
    assert ctx["program"] is None


def _ev(name, dur, depth, attrs=None, dev=None):
    return types.SimpleNamespace(name=name, dur_us=dur, depth=depth,
                                 attrs=attrs or {}, device_dur_us=dev)


def test_summary_of_known_spans():
    events = []
    for rep in range(2):
        events += [_ev("ksection/round", 300.0, 2, {"host_syncs": 1}, 350.0),
                   _ev("balance/keys", 1000.0, 1, {}, 3000.0),
                   _ev("balance/partition1d", 2000.0, 1, {"host_syncs": 4},
                       1500.0),
                   _ev("balance", 3500.0, 0,
                       {"host_syncs": 4, "allocator_calls": 2 * rep,
                        "alloc_retries": 0}, 4600.0)]
    s = program.summarize(events, 2, 0.01)
    assert s["ms"] == 5.0
    assert s["host_ms"] == {"keys": 1.0, "partition1d": 2.0}
    assert s["device_ms"] == {"keys": 3.0, "partition1d": 1.5}
    assert s["host_syncs"] == 4 and s["allocator_calls"] == 1
    assert s["alloc_retries"] == 0
    assert s["spans"]["ksection/round"] == pytest.approx(
        {"calls": 1.0, "host_ms": 0.3, "device_ms": 0.35})
    # spans without device times give no device reading
    cpu = program.summarize([_ev("balance/keys", 1000.0, 1),
                             _ev("balance", 1000.0, 0)], 1, 0.001)
    assert cpu["device_ms"] == {} and cpu["allocator_calls"] is None
    assert cpu["host_syncs"] == 0


def test_idle_by_span_of_a_known_timeline():
    from torch.autograd import DeviceType

    def ev(name, s, e, dev=False, id=0):
        return types.SimpleNamespace(
            name=name, id=id,
            time_range=types.SimpleNamespace(start=s, end=e),
            device_type=DeviceType.CUDA if dev else DeviceType.CPU)
    names = {"balance", "balance/keys", "balance/partition1d",
             "ksection/round", "ksection/sync"}
    events = [ev(program.MARK, 0, 200), ev(program.MARK, 0, 200, True),
              ev("balance", 5, 190),
              ev("balance/keys", 10, 50), ev("balance/partition1d", 50, 170),
              ev("ksection/round", 60, 120), ev("ksection/sync", 110, 120),
              # the ranges' mirrors on the device are no work
              ev("balance/keys", 10, 50, True),
              ev("ksection/round", 60, 120, True),
              ev("aten::argmax", 100, 140),
              ev("cudaLaunchKernel", 20, 22, id=7),
              ev("cudaLaunchKernel", 70, 72, id=8),
              ev("void ns::sfc_keys_kernel<1>(int)", 30, 45, True, id=7),
              ev("void ns::bucket_kernel<1>(float)", 75, 115, True, id=8),
              ev("void ns::bucket_kernel<1>(float)", 150, 160, True, id=9)]
    s = program.span_idle(events, names, reps=2)
    assert s["window_s"] == 200e-6 and s["busy_s"] == pytest.approx(65e-6)
    assert s["idle_s"] == pytest.approx(135e-6)
    # gaps 0-30 (midpoint 15: keys), 45-75 (60: round), 115-150 (132.5:
    # partition1d), 160-200 (180: balance alone)
    assert dict(s["by_span"]) == pytest.approx({
        "balance/keys": 30e-6, "ksection/round": 30e-6,
        "balance/partition1d": 35e-6, "balance": 40e-6})
    assert sum(v for _, v in s["by_span"]) == pytest.approx(s["idle_s"])
    # launches by the stage around their host call; id 9 has no host call
    assert s["launches"] == {"sfc_keys_kernel": {"balance/keys": 1},
                             "bucket_kernel": {"balance/partition1d": 1}}
    assert s["launches_unmatched"] == 1
    # a gap outside every span
    tail = [ev(program.MARK, 0, 260)] + events[1:]
    s = program.span_idle(tail, names, reps=2)
    assert dict(s["by_span"])[program.NO_SPAN] == pytest.approx(100e-6)
    assert program.span_idle([ev("balance", 0, 1)], names, 1) == {}


def test_the_command_line_runs_both_stretches_on_the_cpu(capsys):
    import json
    assert program.main(["--workload", "ex31_steady", "--seed",
                         str(2 ** 31 + 3), "--device", "cpu",
                         "--n", "4096"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n"] == 4096 and out["device"] == "cpu"
    assert "sync_debug" not in out and out["untraced_ms"] > 0
    prog = out["program_stretch"]
    assert set(prog["host_ms"]) == {"keys", "partition1d", "remap",
                                    "migrate", "part_weights"}
    assert prog["device_ms"] == {} and prog["allocator_calls"] is None
    # the stages lie inside the stretch's own time
    assert sum(prog["host_ms"].values()) < prog["ms"]
    assert prog["spans"]["balance"]["calls"] == 1.0
    assert len(prog["host_syncs_each"]) == harness.SPAN_REPS
    idle = out["idle_by_span"]
    assert idle["reps"] == harness.PROFILE_REPS and idle["busy_s"] == 0.0
    assert sum(v for _, v in idle["by_span"]) == pytest.approx(
        idle["idle_s"])
