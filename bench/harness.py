"""One run of one cell: set-up, the measured window, the traced
stretches, the comparison with the reference and the metrics.

A cell is a closed loop with one client: a solver process that blocks
on each step of the system under test.  The configuration names the
loop (``bench/loops/<name>.py``: its ``Loop`` drives the program one
step at a time, each ending in a ``torch.cuda.synchronize()``, and its
``judge`` holds the kept steps against the plain reference); the
traffic mix names the generator of the inputs.
"""
from __future__ import annotations

import json
import random
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import generator, plugins, profiling

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: steps run before the window: the library is loaded, every kernel of
#: the path has run once
WARMUP = 3
#: steps of the window kept for the comparison, drawn from the seed
SAMPLES = 3
#: steps in the profiled stretch and in the spanned stretch
PROFILE_REPS = 6
SPAN_REPS = 4
#: top-level module names that may not be loaded (the port's name begins
#: with the reference package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix and limits, each
    found by the name ``BENCHMARK.json`` gives."""
    cell = _named(bench["workloads"], workload, "workload")
    conf = _named(bench["configs"], cell["config"], "configuration")
    return {"name": workload, "chips": int(cell["chips"]),
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads(
                (BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads(
                (BENCH / "limits" / f"{workload}.json").read_text())}


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``; a metric split by cell family
    (``<base>.<family>``) reads with its base's reader unless it has a
    file of its own."""
    base = name
    while not plugins.path_of("metrics", base).is_file() and "." in base:
        base = base.rsplit(".", 1)[0]
    return plugins.path_of("metrics", base)


def reader(name: str) -> Callable:
    """The metric's ``read(ctx)``: its value, or None where the run has
    nothing to read it from."""
    return plugins.load("metrics", reader_path(name).stem).read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the reference
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_process: float, *, balancer: Optional[Callable] = None,
             min_reps: int = 1, warmup: int = WARMUP,
             metrics: Optional[List[dict]] = None) -> dict:
    """One run: the result line's keys, ``checks`` last.  ``t_process``
    is the process's start on ``time.perf_counter``; ``balancer`` is
    handed to the loop (the object it times in the program's place)."""
    dev = torch.device(device)
    config, limits = cell["config"], cell["limits"]
    inputs = generator.make_inputs(config, cell["traffic"], seed, dev)
    lp = plugins.load("loops", config["loop"])
    loop = lp.Loop(config, inputs, dev, balancer)
    for _ in range(warmup):
        loop.step()
    loop.sync()

    rng = random.Random(seed)
    buffers = [loop.buffer() for _ in range(SAMPLES)]
    kept: List = []
    times: List[float] = []
    counters: Dict[str, List[float]] = {}
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        item = loop.step()
        loop.sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        for k, v in loop.counters(item).items():
            counters.setdefault(k, []).append(v)
        # a uniform sample of the window's steps (reservoir)
        j = len(kept) if len(kept) < SAMPLES else rng.randrange(len(times))
        if j < SAMPLES:
            if j == len(kept):
                kept.append(buffers[j])
            kept[j].take(item)
        if t1 >= deadline and len(times) >= min_reps:
            break
    window_s = t1 - t_start

    ctx = {"n": int(config["n"]), "has_old": not inputs.fresh,
           "setup_s": t_start - t_process, "window_s": window_s,
           "times_s": times, "counters": counters,
           "profile": None, "spans": None, "kernels": None}
    if trace:
        ctx["profile"] = profiling.profile_stretch(loop.step, PROFILE_REPS,
                                                   loop.sync)
        ctx["spans"], ctx["kernels"] = loop.span_stretch(SPAN_REPS)
    loop.sync()
    cuda = dev.type == "cuda"
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if cuda else 0)}
    prof = ctx["profile"]
    if trace and prof:
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]

    # the program's state goes before the reference runs
    del loop, item
    if cuda:
        torch.cuda.empty_cache()
    readings = lp.judge(config, inputs, kept)
    numbers = {k: max(r[k] for r in readings) for k in limits}
    failed = sum(not all(r[k] <= v for k, v in limits.items())
                 for r in readings)

    values = {}
    for m in (metrics or []):
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": failed == 0, "attempted": len(times), "failed": failed,
           "metrics": values, "device": device_info}
    if trace and prof:
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return out


def p95(values: List[float]) -> float:
    """The 95th percentile, between the two nearest of the sorted
    values (``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]
