"""What the traced run reads besides the window: a stretch of
repartitions under ``torch.profiler``, and a stretch with a span around
each stage of the pipeline and CUDA events around each kernel call.

Both wrap the program from outside and edit none of its files: the
stages are re-registered through ``core.spec.register_stage`` and put
back afterwards; the kernel wrappers are swapped in ``kernels.ops``,
whose dispatch looks them up at each call.
"""
from __future__ import annotations

import heapq
import re
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import yardstick

MARK = "bench.stretch"
#: device kernels a wrapper launches, by the name the profiler gives them
WRAPPER_KERNELS = {"sfc_keys": ("sfc_keys_kernel",),
                   "ksection_hist": ("prep_kernel", "bucket_kernel")}
TOP = 10
NAME_CHARS = 160


def _wrapper_of(name: str) -> Optional[str]:
    for wrapper, kernels in WRAPPER_KERNELS.items():
        if any(re.search(rf"(?:^|[\s:]){k}\s*[<(]", name) for k in kernels):
            return wrapper
    return None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _host_at(points: List[float], host: List[Tuple[float, float, str]]
             ) -> List[str]:
    """For each time in ``points`` (ascending), the innermost host op
    running then: of those that cover it, the one that started last."""
    host = sorted(host)
    heap: List[Tuple[float, float, str]] = []
    out, i = [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            s, e, name = host[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "(no host op)")
    return out


def summarize(events, reps: int) -> Dict:
    """Busy and idle time of the device inside the marked stretch, its
    kernel launches, the device ops that took most time and the longest
    idle stretches grouped by the host op that ran meanwhile."""
    from torch.autograd import DeviceType
    mark = [e for e in events if e.name == MARK]
    if not mark:
        return {}
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the marker's own range is mirrored on the device's timeline
            if e.name != MARK and t > w0 and s < w1:
                dev.append((max(s, w0), min(t, w1), e.name))
        elif e.name != MARK:
            host.append((s, t, e.name))
    merged = _union([(s, t) for s, t, _ in dev])
    busy_us = sum(t - s for s, t in merged)
    by_name: Dict[str, float] = {}
    wrappers: Dict[str, int] = {}
    launches = 0
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
        w = _wrapper_of(name)
        if w:
            wrappers[w] = wrappers.get(w, 0) + 1
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    names = _host_at([(s + t) / 2 for s, t in gaps], host)
    idle: Dict[str, float] = {}
    for (s, t), name in zip(gaps, names):
        idle[name] = idle.get(name, 0.0) + (t - s)

    def top(d):
        # a kernel's demangled name runs to a thousand characters
        return [[k[:NAME_CHARS], v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"reps": reps, "window_s": (w1 - w0) / 1e6,
            "busy_s": busy_us / 1e6, "launches": launches,
            "wrapper_kernels": wrappers, "device_ops": top(by_name),
            "idle_gaps": top(idle)}


def profile_stretch(step: Callable, reps: int, sync: Callable) -> Dict:
    """``reps`` repartitions under torch.profiler (host and device).
    Where the trace holds fewer of the wrappers' kernels than
    ``ops.launch_counts()`` counts as launched, the summary names them
    under ``lost_kernels`` and says so on standard error."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    before = ops.launch_counts()
    sync()
    with profile(activities=acts) as prof:
        with record_function(MARK):
            for _ in range(reps):
                step()
            sync()
    after = ops.launch_counts()
    summary = summarize(prof.events(), reps)
    if summary:
        seen = summary["wrapper_kernels"]
        lost = {k: want - seen.get(k, 0) for k, want in
                (("sfc_keys", after["sfc_keys"] - before["sfc_keys"]),
                 ("ksection_hist", 2 * (after["ksection_hist"]
                                        - before["ksection_hist"])))
                if seen.get(k, 0) < want}
        if lost:
            summary["lost_kernels"] = lost
            print(f"profiler: kernels launched but not traced: {lost}",
                  file=sys.stderr, flush=True)
    return summary


STAGES = (("keys", "sfc"), ("partition1d", "ksection"), ("remap", "greedy"),
          ("migrate", "metrics"))


def span_stretch(step: Callable, reps: int, sync: Callable,
                 oneD: str) -> Tuple[Dict[str, float],
                                     Dict[str, Tuple[float, float]]]:
    """``reps`` repartitions with a span (synchronised at both ends)
    around each stage the registry resolves, and a pair of CUDA events
    around each kernel call.  Returns each stage's ms per repartition
    and, per kernel, (device seconds, bound seconds) summed over calls."""
    from repro_torch.core import spec as core_spec
    from repro_torch.kernels import ops
    spans: Dict[str, List[float]] = {}
    stages = [(s, oneD if s == "partition1d" else v) for s, v in STAGES]
    originals = {s: core_spec.get_stage("host", s, v) for s, v in stages}

    def spanned(stage, fn):
        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            spans.setdefault(stage, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return run

    calls: List[Tuple[str, object, object, float]] = []
    kernel_fns = {"sfc_keys": ops.sfc_keys_cuda,
                  "ksection_hist": ops.ksection_hist_cuda}

    def evented(name, fn):
        def run(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            n = args[0].shape[0]
            bound = (yardstick.sfc_keys_bound_s(n) if name == "sfc_keys"
                     else yardstick.ksection_hist_bound_s(n, args[2].shape[0]))
            calls.append((name, a, b, bound))
            return out
        return run

    for s, v in stages:
        core_spec.register_stage("host", s, v)(spanned(s, originals[s]))
    ops.sfc_keys_cuda = evented("sfc_keys", kernel_fns["sfc_keys"])
    ops.ksection_hist_cuda = evented("ksection_hist",
                                     kernel_fns["ksection_hist"])
    try:
        for _ in range(reps):
            step()
        sync()
    finally:
        for s, v in stages:
            core_spec.register_stage("host", s, v)(originals[s])
        ops.sfc_keys_cuda = kernel_fns["sfc_keys"]
        ops.ksection_hist_cuda = kernel_fns["ksection_hist"]
    kernels: Dict[str, Tuple[float, float]] = {}
    for name, a, b, bound in calls:
        t, bd = kernels.get(name, (0.0, 0.0))
        kernels[name] = (t + a.elapsed_time(b) / 1e3, bd + bound)
    return {s: sum(v) / reps for s, v in spans.items()}, kernels
