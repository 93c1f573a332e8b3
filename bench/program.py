"""What the program's own spans and counts say, in a traced run: the
readings of ``stage_host_ms``, ``stage_device_ms``,
``host_syncs_per_repartition`` and ``allocator_calls_per_repartition``.

* ``program_stretch`` -- repartitions under the program's tracer in
  device mode (``repro_torch.telemetry.Tracer(device=...)``), with no
  sync beyond the program's own and one at the end: each stage span's
  host and device ms, the ``balance`` span's ``host_syncs`` and
  ``allocator_calls``, and the stretch's own ms, a repartition.
* ``idle_by_span`` -- repartitions under ``torch.profiler`` with a
  host-only tracer active, whose spans then lie on the profiler's clock:
  each idle gap of the device goes to the innermost span running at its
  midpoint, and each launch of the benchmark's kernels to the stage that
  launched it.

``of(ctx)`` gives the readers the program stretch, measured once a run
and kept in ``ctx["program"]``.  The harness hands a reader ``ctx``
alone, which holds no loop: the cell's configuration, inputs and device
are taken from the frame of ``harness.run_cell`` that calls the reader,
and a new loop on them is warmed up and run after the run's own
stretches, the reference and the other readers' numbers.  A program
whose tracer has no device mode gives None, and so do its readers.

``python3 -m bench.program --workload <cell> --seed <n>`` (from the root
of a checkout, ``src`` on ``PYTHONPATH``) runs both stretches on one
cell, with the sync count that ``torch.cuda.set_sync_debug_mode`` gives
over the same repartitions and their time untraced, and prints one JSON
line.  ``idle_by_span`` stays out of the traced run: processing the
profile of ex32's launches takes about as long as the profiled stretch
the run already has.
"""
from __future__ import annotations

import contextlib
import json
import re
import sys
import time
from typing import Callable, Dict, List, Optional, Set

import torch

from . import profiling

MARK = "bench.program_stretch"
STAGE = "balance/"
NO_SPAN = "(no span)"
#: the benchmark's kernels whose launches are put down to a stage
KERNELS = ("sfc_keys_kernel", "prep_kernel", "bucket_kernel")


def _per_rep(values: List[Optional[float]], reps: int, scale: float = 1.0
             ) -> Optional[float]:
    if not values or any(v is None for v in values):
        return None
    return scale * sum(values) / reps


def summarize(events, reps: int, wall_s: float) -> Dict:
    """A repartition's share of a stretch's spans: the ``balance/<stage>``
    spans' host and device ms by stage, every span's calls, host ms and
    device ms by name, the ``balance`` spans' counts."""
    by_name: Dict[str, List] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    names = {}
    for name, evs in by_name.items():
        names[name] = {"calls": len(evs) / reps,
                       "host_ms": _per_rep([e.dur_us for e in evs], reps,
                                           1e-3),
                       "device_ms": _per_rep([e.device_dur_us for e in evs],
                                             reps, 1e-3)}
    top = by_name.get("balance", [])
    stages = {n[len(STAGE):]: v for n, v in names.items()
              if n.startswith(STAGE)}
    return {"reps": reps, "ms": 1e3 * wall_s / reps,
            "host_ms": {s: v["host_ms"] for s, v in stages.items()},
            "device_ms": {s: v["device_ms"] for s, v in stages.items()
                          if v["device_ms"] is not None},
            "host_syncs": _per_rep([e.attrs.get("host_syncs", 0)
                                    for e in top], reps),
            "host_syncs_each": [e.attrs.get("host_syncs", 0) for e in top],
            "allocator_calls": _per_rep(
                [e.attrs.get("allocator_calls") for e in top], reps),
            "alloc_retries": _per_rep(
                [e.attrs.get("alloc_retries") for e in top], reps),
            "spans": names}


def program_stretch(step: Callable, reps: int, sync: Callable, device
                    ) -> Dict:
    """``reps`` repartitions under a tracer that times its spans on the
    card where ``device`` is one."""
    from repro_torch import telemetry
    sync()
    tr = telemetry.Tracer(device=torch.device(device).type == "cuda")
    t0 = time.perf_counter()
    with telemetry.tracing(tr):
        for _ in range(reps):
            step()
    sync()
    wall = time.perf_counter() - t0
    return summarize(tr.resolve(), reps, wall)


def _named(name: str) -> Optional[str]:
    for k in KERNELS:
        if re.search(rf"(?:^|[\s:]){k}\s*[<(]", name):
            return k
    return None


def span_idle(events, span_names: Set[str], reps: int) -> Dict:
    """Device idle time inside the marked stretch by the innermost program
    span running at each gap's midpoint (``NO_SPAN`` outside them), and
    the launches of ``KERNELS`` by the ``balance/`` stage around the host
    call that launched them (matched by correlation id)."""
    from torch.autograd import DeviceType
    mark = [e for e in events
            if e.name == MARK and e.device_type != DeviceType.CUDA]
    if not mark:
        return {}
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    dev, spans, runtime, kernels = [], [], {}, []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        on_device = e.device_type == DeviceType.CUDA
        if e.name == MARK or e.name in span_names:
            # a range's mirror on the device's timeline is no work
            if not on_device and e.name != MARK:
                spans.append((s, t, e.name))
        elif on_device:
            if t > w0 and s < w1:
                dev.append((max(s, w0), min(t, w1)))
            k = _named(e.name)
            if k:
                kernels.append((e.id, k))
        elif e.name.startswith("cu"):
            runtime[e.id] = s
    merged = profiling._union(dev)
    busy = sum(t - s for s, t in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle: Dict[str, float] = {}
    for (s, t), name in zip(gaps, profiling._host_at(
            [(s + t) / 2 for s, t in gaps], spans)):
        name = NO_SPAN if name == "(no host op)" else name
        idle[name] = idle.get(name, 0.0) + (t - s)
    launched = [(runtime[i], k) for i, k in kernels if i in runtime]
    launched.sort()
    stages = profiling._host_at([t for t, _ in launched],
                                [sp for sp in spans
                                 if sp[2].startswith(STAGE)])
    by_stage: Dict[str, Dict[str, int]] = {}
    for (_, k), stage in zip(launched, stages):
        stage = NO_SPAN if stage == "(no host op)" else stage
        by_stage.setdefault(k, {})
        by_stage[k][stage] = by_stage[k].get(stage, 0) + 1
    return {"reps": reps, "window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "idle_s": (w1 - w0 - busy) / 1e6,
            "by_span": [[k, v / 1e6] for k, v in
                        sorted(idle.items(), key=lambda kv: -kv[1])],
            "launches": by_stage,
            "launches_unmatched": len(kernels) - len(launched)}


def idle_by_span(step: Callable, reps: int, sync: Callable) -> Dict:
    """``reps`` repartitions under torch.profiler (host and device) with
    a host-only tracer active."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import telemetry
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    tr = telemetry.Tracer()
    sync()
    with profile(activities=acts) as prof:
        with record_function(MARK):
            with telemetry.tracing(tr):
                for _ in range(reps):
                    step()
            sync()
    return span_idle(prof.events(), {e.name for e in tr.events}, reps)


def has_device_tracer() -> bool:
    """Whether the program's tracer times spans on the card."""
    import inspect
    from repro_torch import telemetry
    return (hasattr(telemetry.Tracer, "resolve") and "device" in
            inspect.signature(telemetry.Tracer).parameters)


def _run_cell_frame():
    from . import harness
    frame = sys._getframe()
    while frame is not None and frame.f_code is not harness.run_cell.__code__:
        frame = frame.f_back
    return frame


def warm_loop(lp, config, inputs, device, *, traced: bool, balancer=None,
              warmup=None):
    """A new loop of the cell after ``warmup`` repartitions (the
    harness's ``WARMUP``); every loop made so repeats the same
    repartitions.  ``traced`` runs them under a tracer like the
    stretch's: the first traced repartition of a process pays a one-time
    cost (~30 ms on the card), which is set-up."""
    from repro_torch import telemetry
    from . import harness
    loop = lp.Loop(config, inputs, device, balancer)
    cuda = torch.device(device).type == "cuda"
    with (telemetry.tracing(telemetry.Tracer(device=cuda)) if traced
          else contextlib.nullcontext()):
        for _ in range(harness.WARMUP if warmup is None else warmup):
            loop.step()
    loop.sync()
    return loop


def of(ctx: Dict) -> Optional[Dict]:
    """The run's program stretch (None where there is nothing to read),
    measured at the first call and kept in ``ctx["program"]``; printed
    on standard error beside the window's ms a repartition."""
    if "program" not in ctx:
        from . import harness
        ctx["program"] = None
        frame = _run_cell_frame()
        if frame is not None and frame.f_locals.get("trace") and \
                has_device_tracer():
            run = frame.f_locals
            dev = run["dev"]
            loop = warm_loop(run["lp"], run["config"], run["inputs"], dev,
                             traced=True, balancer=run["balancer"],
                             warmup=run["warmup"])
            ctx["program"] = program_stretch(loop.step, harness.SPAN_REPS,
                                             loop.sync, dev)
            del loop
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            line = dict(ctx["program"], window_ms=1e3 * ctx["window_s"]
                        / len(ctx["times_s"]))
            print("program_stretch " + json.dumps(line), file=sys.stderr,
                  flush=True)
    return ctx["program"]


def stage_reading(ctx: Dict, clock: str, stage: str) -> Optional[float]:
    """A stage's ``host_ms`` or ``device_ms`` a repartition."""
    prog = of(ctx)
    return None if prog is None else prog[clock].get(stage)


def reading(ctx: Dict, key: str) -> Optional[float]:
    prog = of(ctx)
    return None if prog is None else prog[key]


def sync_debug_counts(step: Callable, reps: int) -> List[int]:
    """Synchronising calls that ``torch.cuda.set_sync_debug_mode("warn")``
    reports in each of ``reps`` repartitions, tracing off."""
    import warnings
    counts = []
    for _ in range(reps):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchronizing CUDA operation" in str(w.message)
                          for w in seen))
    return counts


def main(argv=None) -> int:
    """One cell's program stretch, idle by span and, on a card, the sync
    count that sync debug mode gives over the same repartitions, and the
    same repartitions untraced; one JSON line."""
    import argparse
    from . import generator, harness, plugins
    ap = argparse.ArgumentParser(description=main.__doc__.split(";")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, help="elements (default: the cell's)")
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    config, dev = cell["config"], torch.device(args.device)
    if args.n:
        config["n"] = args.n
    inputs = generator.make_inputs(config, cell["traffic"], args.seed, dev)
    lp = plugins.load("loops", config["loop"])
    reps = harness.SPAN_REPS
    out = {"workload": args.workload, "seed": args.seed, "n": config["n"],
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    if dev.type == "cuda":
        loop = warm_loop(lp, config, inputs, dev, traced=False)
        out["sync_debug"] = sync_debug_counts(loop.step, reps)
    # untraced, each repartition ended by a sync as in the window
    loop = warm_loop(lp, config, inputs, dev, traced=False)
    t0 = time.perf_counter()
    for _ in range(reps):
        loop.step()
        loop.sync()
    out["untraced_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    loop = warm_loop(lp, config, inputs, dev, traced=True)
    out["program_stretch"] = program_stretch(loop.step, reps, loop.sync, dev)
    out["idle_by_span"] = idle_by_span(loop.step, harness.PROFILE_REPS,
                                       loop.sync)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
