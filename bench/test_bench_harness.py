"""CPU tests of the harness: what it finds by name, the traffic, the byte
counts, the JAX check and the refusals without a card or a program."""
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import check, generator, harness, plugins, profiling, yardstick

ROOT = Path(__file__).resolve().parents[1]
BENCH = harness.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_its_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_pieces_are_found_by_name(workload):
    cell = harness.find_cell(BENCH, workload)
    conf = cell["config"]
    assert conf["n"] > 0 and conf["spec"]["p"] > 1
    assert {"parts_mismatch", "imbalance_excess"} <= set(cell["limits"])
    assert set(cell["limits"]) <= set(check.NUMBERS)
    # the remap and the migration are held wherever old parts come in
    assert ("migration_gap" in cell["limits"]) == (
        not cell["traffic"]["fresh"])
    loop = plugins.load("loops", conf["loop"])
    assert callable(loop.Loop) and callable(loop.judge)
    assert callable(plugins.load("generators",
                                 cell["traffic"]["generator"]).make_inputs)
    assert callable(plugins.load("domains", conf["domain"]["kind"]).points)
    table = json.loads((ROOT / conf["levels"]).read_text())
    assert callable(plugins.load("features", table["feature"]).feature)
    for trace in (False, True):
        for m in harness.metrics_of(BENCH, workload, trace):
            assert callable(harness.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    """A metric split by cell, ``<base>.<cell>``, reads with its base's
    reader; every reader serves some metric."""
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    used = {harness.reader_path(n) for n in named}
    files = set((ROOT / "bench" / "metrics").glob("*.py"))
    assert used == files
    assert harness.reader_path("stage_ms.keys.ex31_steady").name == (
        "stage_ms.keys.py")
    assert harness.reader_path("repartition_ms.ex32_moving_peak").name == (
        "repartition_ms.py")


def test_each_cell_reports_its_own_end_to_end_metrics():
    """Every cell reports setup_s and its own times, each with a bound
    of its own; every per-layer metric moves an end-to-end metric that
    each of its cells reports."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in WORKLOADS:
        names = {m["name"] for m in harness.metrics_of(BENCH, w, False)}
        assert names == {"setup_s", f"repartition_ms.{w}",
                         f"repartition_p95_ms.{w}"}
        assert harness.metrics_of(BENCH, w, True)
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", WORKLOADS))


def test_configuration_files_state_their_cut():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert conf["assumed"] and conf["source"].startswith("https://")


@pytest.mark.parametrize("traffic", sorted(
    {w["traffic"] for w in BENCH["workloads"]}))
def test_traffic_is_fixed_by_the_seed(traffic):
    cell = harness.find_cell(BENCH, next(
        w["name"] for w in BENCH["workloads"] if w["traffic"] == traffic))
    conf = dict(cell["config"], n=2048)
    a = generator.make_inputs(conf, cell["traffic"], 2 ** 31 + 5, "cpu")
    b = generator.make_inputs(conf, cell["traffic"], 2 ** 31 + 5, "cpu")
    c = generator.make_inputs(conf, cell["traffic"], 6, "cpu")
    assert torch.equal(a.coords, b.coords) and a.start == b.start
    assert all(torch.equal(x, y) for x, y in zip(a.fields, b.fields))
    assert not torch.equal(a.coords, c.coords)
    # every seed the same elements and weights, in another order
    key = lambda inp: torch.sort(inp.coords[:, 0] * 7 + inp.fields[0]).values
    assert torch.equal(key(a), key(c))
    table = json.loads((ROOT / conf["levels"]).read_text())
    assert len(a.fields) == len(c.fields) == len(table["steps"])
    for f in a.fields + c.fields:
        assert f.shape == (2048,) and f.dtype == torch.float32
        assert set(torch.unique(f).tolist()) <= {2.0 ** k for k in range(10)}


def test_moving_peak_moves_and_steady_levels_keep_their_ranks():
    cell = harness.find_cell(BENCH, "ex32_moving_peak")
    conf = dict(cell["config"], n=1 << 16)
    inp = generator.make_inputs(conf, cell["traffic"], 3, "cpu")
    # the refined region's centre of weight moves from step to step
    top = [(inp.coords * f[:, None]).sum(0) / f.sum() for f in inp.fields[:2]]
    assert float((top[0] - top[1]).norm()) > 0.01
    f0, f1 = inp.fields[0].double(), inp.fields[1].double()
    moved = float((f0 / f0.sum() - f1 / f1.sum()).abs().sum() / 2)
    assert 0.05 < moved < 0.3
    # the stationary solve's levels follow no position: an element keeps
    # its rank among the step's levels from step to step
    cell = harness.find_cell(BENCH, "ex31_steady")
    conf = dict(cell["config"], n=1 << 16)
    inp = generator.make_inputs(conf, cell["traffic"], 3, "cpu")
    for f, g in zip(inp.fields, inp.fields[1:]):
        lo, hi = f < g.min(), g < f.min()
        assert not bool(((f > f.min()) & (g == g.min()) & (f > 2 * g)).any())
        assert not bool(lo.any() and hi.any())


def test_level_tables_hold_volume_shares():
    """Each recorded step: a bin per feature interval, a cumulative
    share of volume per level that rises to 1; the recorder's table of a
    known mesh gives the shares back."""
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        table = json.loads((ROOT / conf["levels"]).read_text())
        for step in table["steps"]:
            assert len(step["cdf"]) == len(step["edges"]) + 1
            assert step["edges"] == sorted(step["edges"])
            for row in step["cdf"]:
                assert row == sorted(row) and row[-1] == 1.0
    rec = plugins.load("levels", "record")
    f = np.array([0.1, 0.2, 0.3, 0.4])
    level = np.array([3, 3, 4, 5])
    vol = np.array([2.0, 2.0, 1.0, 3.0])
    tab = rec.table(f, level, vol, 2)
    assert tab["base_level"] == 3 and tab["edges"] == [0.3]
    assert tab["cdf"] == [[1.0, 1.0, 1.0], [0.0, 0.25, 1.0]]
    # within the bins (1 * 0.75^2 + 3 * 0.25^2) / 8 of the 6.875 / 8 about
    # the mean level 3.875 is left
    assert rec.explained(f, level, vol, tab) == pytest.approx(
        1 - 0.75 / 6.875)


def test_byte_counts():
    n = 1 << 27
    assert yardstick.sfc_keys_bound_s(n) == 16 * n / 3.35e12
    assert yardstick.ksection_hist_bound_s(n, 8184) == pytest.approx(
        (8 * n + 8 * 8184) / 3.35e12)
    # few items against many cuts: the compares bound it
    assert yardstick.ksection_hist_bound_s(10, 2 ** 20) == pytest.approx(
        max((80 + 8 * 2 ** 20) / 3.35e12, 10 * 21 / 67e12))
    assert yardstick.repartition_bytes(n, True) == 32 * n
    assert yardstick.repartition_bytes(n, False) == 24 * n


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    fake = dict(sys.modules)
    for name in ("jax", "repro", "flax", "jaxlib"):
        fake.pop(name, None)
    fake = {k: v for k, v in fake.items()
            if k.split(".")[0] not in harness.FORBIDDEN}
    fake["repro_torch.core"] = types.ModuleType("x")
    fake["jaxtyping_like"] = types.ModuleType("y")
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake["repro.core.sfc"] = types.ModuleType("z")
    fake["jax.numpy"] = types.ModuleType("w")
    assert harness.forbidden_modules() == ["jax", "repro"]


def _python(code_or_args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_what_bench_runs_loads_no_jax():
    """A whole tiny run of every cell on the CPU, in a fresh process:
    afterwards no module of JAX or of the reference package is loaded."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from bench import harness, control\n"
        "b = harness.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = harness.find_cell(b, w['name'])\n"
        "    c['config']['n'] = 2048; c['config']['spec']['p'] = 8\n"
        "    for t in (False, True):\n"
        "        o = harness.run_cell(c, 1, 0.01, t, 'cpu', 0.0,\n"
        "            metrics=harness.metrics_of(b, w['name'], t))\n"
        "        assert o['correct'], o\n"
        "print('forbidden', harness.forbidden_modules())\n"
        "print('loaded', sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = _python(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "forbidden []" in out.stdout
    loaded = out.stdout.split("loaded ")[1]
    assert "'repro_torch'" in loaded and "'repro'" not in loaded


def test_run_refuses_to_measure_without_a_card():
    out = _python(["bench/run.py", "--workload", WORKLOADS[0], "--seed", "3",
                   "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _python(["bench/run.py", "--workload", WORKLOADS[0], "--seed", "3",
                   "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_trace_run_reads_spans_and_counters_on_the_cpu():
    cell = harness.find_cell(BENCH, "ex32_moving_peak")
    cell["config"]["n"], cell["config"]["spec"]["p"] = 4096, 16
    out = harness.run_cell(cell, 9, 0.05, True, "cpu", 0.0,
                           metrics=harness.metrics_of(BENCH,
                                                      "ex32_moving_peak",
                                                      True))
    m = out["metrics"]
    for stage in ("keys", "partition1d", "remap", "migrate"):
        assert m[f"stage_ms.{stage}.ex32_moving_peak"]["value"] > 0
    assert m["ksection_rounds.ex32_moving_peak"]["unit"] == "rounds"
    # no device here: the readers of the device trace read nothing
    assert "sfc_keys_roofline.ex32_moving_peak" not in m
    assert list(out)[-1] == "checks"


def test_a_stretch_that_lost_kernels_gives_no_launch_count():
    read = harness.reader("launches_per_repartition.ex31_steady")
    prof = {"busy_s": 0.6, "reps": 6, "window_s": 1.3, "launches": 12}
    assert read({"profile": prof}) == 2
    assert read({"profile": dict(prof, lost_kernels={"sfc_keys": 1})}) is None


def test_profile_summary_of_a_known_timeline():
    from torch.autograd import DeviceType

    def ev(name, s, e, dev=False):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=s, end=e),
            device_type=DeviceType.CUDA if dev else DeviceType.CPU)
    events = [ev(profiling.MARK, 0, 100), ev(profiling.MARK, 0, 100, True),
              ev("aten::argmax", 10, 40), ev("cudaLaunchKernel", 20, 25),
              ev("aten::item", 60, 95),
              ev("void ns::bucket_kernel<1>(float)", 30, 50, True),
              ev("argmax_kernel", 45, 60, True),
              ev("Memcpy DtoH (Device -> Pinned)", 90, 92, True)]
    s = profiling.summarize(events, reps=2)
    assert s["window_s"] == 100e-6 and s["busy_s"] == pytest.approx(32e-6)
    assert s["launches"] == 2
    assert s["wrapper_kernels"] == {"ksection_hist": 1}
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"aten::argmax": 30e-6, "aten::item": 30e-6,
                                  "(no host op)": 8e-6})
