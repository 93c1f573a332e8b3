#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  It

1. prints the card and builds the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` (into ``build/kernels``);
2. drives the first main path -- an adaptive Helmholtz session (paper
   Example 3.1) from 786,432 tets with incremental k-section balancing on
   64 parts -- and checks that each of its kernels was launched, with
   the summation orders built per step; its first two steps run under
   torch.profiler, whose summary gives the device's idle share (an upper
   bound where the profiler's kernel events fall short of the wrappers'
   launches) and where the host time goes; then runs a
   smoke-size session on the card twice (equal bit for bit at every
   step: the FEM's sums add in a fixed order) and replays each of its
   steps on the CPU from the card's mesh;
3. holds the FEM path's kernels against their plain PyTorch versions at
   the session's shapes, timing both by CUDA events (device and call
   times); the SFC keys also on every point of the 2^30 grid, both
   curves, with the integer instructions a key costs (from the SASS);
   the histogram with its kernels a call; the element matvec also for
   equal bits over two calls, with its plan's build time; the FEM's
   fixed-order sum on the mesh's kept order beside an order built per
   call;
4. replays the last balance with the kernels and with the plain versions
   (every field equal);
5. runs the standalone DLB step at scale: 8M points, p = 1024, hsfc and
   msfc x sorted and k-section, kernels against plain versions;
6. drives the second main path: the serving session at llama3-8b width
   (random bf16 weights from a seed, 16 slots x 2048 tokens, 4 groups)
   over a seeded 32-request bursty trace with packed prefill, replicated
   decode and tag rebalancing, and prints throughput, TTFT, ITL,
   admission rate, buffer fill, each rebalance and the peak memory; holds
   the histogram kernel against its plain version on every input the
   serving balancer handed it;
7. runs the trace again recorded, packed and with per-request ('full')
   prefill, and holds the two against each other: first-token logits
   within a stated bf16 tolerance, tokens equal up to a near-tie;
8. runs a smoke-size packed session in float32 with the kernels on the
   card and with the plain versions on the CPU, from the same weights;
9. holds both attention kernels against their plain versions (with
   SDPA's time as the yardstick; flash in bf16 on the tensor cores and
   in float32 on CUDA cores; packed in bf16 on the tensor cores, on the
   session's fullest buffer and on a full buffer of long requests) and
   profiles one packed admission plus eight decode steps;
10. runs the standalone sharded DLB step: 8M points over 4 ranks
    (hsfc, sorted and k-section, with old parts and the all_to_all
    migration), equal to the host backend on the card;
11. drives the third main path: the sharded adaptive session over 4
    ranks from the 786,432-tet mesh, owned vertex layout, repartition
    and migration every step; each step's partition is held against the
    host backend, its owned PCG solution against the replicated-layout
    solve of the same packing, its migration to conservation, and every
    rank's own load vector against rank 0's, bit for bit;
12. holds the prefix-scan kernel against its plain version at the
    shard lengths phase 11 scanned and more (integer weights equal,
    floats within 1e-6 of sum|x|, the same bits every call) and times
    it beside torch.cumsum, device and call times;
13. drives the fourth main path: the serving session of phase 6 with
    sharded decode and KV migration (``decode="sharded"``,
    ``rebalance="kv"``) over 4 ranks, one per request group, with phase
    6's bf16 weights handed to the ranks (by CUDA IPC where they share
    its card); checks that every rank gives the same tokens, groups and
    migration log, the tokens against phase 6's replicated run up to a
    near-tie, the migrated bytes against the executor's, the histogram
    kernel against its plain version on every input the balancer
    handed it, and a forced migration against the same run without it,
    bit for bit; prints throughput, TTFT, ITL, each migration's seconds,
    all_to_all and host-staged bytes, each rank's peak memory, the
    forced migration's device time and rank 0's idle share over one
    admission and 8 decode steps with no rebalance;
14. frees phase 6's model and serves h2o-danube3-4b at full width and
    depth with full prefill over a ring of 4,096 positions (prompts of
    4,608-6,144 tokens: every prefill passes the window, every decode
    reads a wrapped ring); checks that every flash launch ran on the
    tensor cores with the window and that every ring row holds the
    newest positions; holds the flash kernel with the window against its
    plain version at s = 6,144, d = 120; then the SMOKE config with a
    ring (window 32), card against CPU in float32;
15. serves h2o-danube-1.8b (d = 80) and command-r-plus (96 / 8 heads,
    vocab 256,000; depth cut to fit the card) packed and full over the
    trace of phase 6, held against each other as phase 7 does, and both
    attention kernels at each model's heads;
16. serves phi3.5-moe (16 experts, top 2; depth cut) packed and full;
    prints each layer's expert imbalance and drop rate for one recorded
    packed admission; runs one MoE layer on a recorded hidden state in
    bf16 against float32 (slots and keep equal); SMOKE card against CPU,
    packed and full;
17. serves grok-1 (8 experts, soft cap 30; depth cut) packed, with the
    cap at every packed launch, and holds the capped packed kernel
    against its plain version on the session's fullest buffer; SMOKE
    card against CPU;
18. serves mamba2-1.3b at full width and depth (48 layers) with full
    prefill over the trace of phase 6 (vocab 50,280) and over phase
    14's long prompts (max_seq 8,192): no attention kernel runs, the
    balancer's histogram is held against its plain version on every
    input; prints the slot bytes as built (the reference's count) and
    after decode (float32 conv windows); the SMOKE config card against
    CPU; then (18b) phase 13's machinery at mamba2 width with full
    prefill: 4 ranks, weights by CUDA IPC, tokens against phase 18's
    replicated run up to a near-tie, a forced migration against the
    unmoved run bit for bit, moved bytes against the reference's count;
19. serves recurrentgemma-2b at full width and depth (26 layers, 8 of
    them local attention at d = 256 over 10 / 1 heads) with full prefill
    over phase 14's long prompts and a ring of 2,048 (every ring row
    checked in every attention layer, every flash launch on the tensor
    cores with the window) and over phase 6's trace; holds the flash
    kernel at d = 256 against its plain version at s = 6,144 with SDPA's
    time beside it; the SMOKE config with a ring, card against CPU;
20. serves whisper-medium at full width and depth (24 encoder and 24
    decoder layers): the batch API with 16 rows of 1,500 stub frames and
    128-token prompts, then 64 decode steps (every flash launch bf16 on
    the tensor cores at the encoder's, the decoder's and the
    cross-attention's shapes, 72 at prefill and 24 a step), held against
    the plain route on the card; a 'cheap' session over phase 6's trace
    (vocab 51,865), the reference's engine path; the flash kernel at
    the encoder's (1,500 x 1,500, no mask) and the cross-attention's
    (128 x 1,500 and 1 x 1,500) shapes against its plain version with
    SDPA's time beside it; the SMOKE config's batch API and cheap
    session, card against CPU;
21. serves qwen2-vl-72b at full width (depth cut) with full prefill over
    phase 6's trace (packed refused with the "mrope" message; every flash
    launch bf16 at 64 / 8 heads), then the VLM front end: 4 rows of 256
    patch embeddings before 128-token prompts and 8 decode steps, held
    against the plain route; the flash kernel at qwen2-vl's shape (64 /
    8 heads, d = 128, causal) at each prompt length of the session,
    against its plain version with SDPA's time beside it; the SMOKE
    config, card against CPU;
22. drives the fifth main path, training: llama3-8b at full width (depth
    cut to TRAIN_DEPTH; bf16, remat, the plain attention as in the
    reference) through ``launch.train.train`` on 4 x 2,048-token batches
    of the synthetic corpus packed on the card (``prefix_scan`` at every
    batch), 5 steps on the stream and 5 on one repeated batch, with each
    step's split, tokens/s, peak memory and model-FLOPs share, then layer
    0's and the head's bf16 gradients through ``_ProductF32`` held against
    float32 recomputes (22a); the packer on the card against the CPU,
    batches and parts bit for bit, every input it handed ``prefix_scan``
    and ``ksection_hist`` held against the plain versions (22b); every
    architecture's SMOKE config trained 3 steps on the card and on the
    CPU from the same weights, llama also compressed, every SMOKE
    config's bf16 gradients through ``_ProductF32`` against float32
    recomputes, and a checkpoint restored and resumed on the card bit for
    bit (22c);
23. prints the kernel table as one JSON line (with each rank's launches
    on main path 4 as ``launches_sharded_serving``, each path of phases
    14-22 in ``launches_by_path``, the flash kernel's d = 256 reading as
    ``at_head_dim_256``, whisper's as ``at_encoder``, ``at_cross_prefill``
    and ``at_cross_decode``, and qwen2-vl's as ``at_qwen2_vl``), the
    card's name and power limit, and ``{"ok": true, ...}`` as the last
    line.

Ranks: with 4 or more cards, one rank per card over NCCL; with fewer,
the 4 ranks share cuda:0 and their collectives go through gloo, staged
through host memory (the script prints which).  The kernels are built
before any rank starts, so the ranks only load the library.

A failed check is printed and the run goes on to the next phase; at the
end, any failure makes the script exit 1 without the last two lines.
Without CUDA it exits 2 before doing anything.
"""
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
TRACED_STEPS = 2        # session steps run under the profiler


def log(*args):
    print(*args, flush=True)


def device_events(prof):
    """The device-side events (kernels, memsets, copies) of a profile."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def timed_ms(fn, reps=20, warmup=3):
    """(device ms, call ms) per call of ``fn`` on the card.

    Call ms is CUDA events around ``reps`` back-to-back calls: it
    includes host dispatch wherever that outlasts the device work.
    Device ms is the same, with the calls queued behind a sleep on the
    card that outlasts their dispatch, so the card runs them back to
    back: host dispatch drops out, the card's own gap between two queued
    kernels (about a microsecond) stays in, and a call that waits for
    the card inside is timed with its host work (a printed note says
    so).  torch.profiler's device events are not used here: on the card
    they have come back with kernels missing from a window (16 of 20)
    and with times that disagree with these by 2x."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    sleep_ms = 2.0 * reps * call_ms + 1.0
    torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if dispatch_ms > sleep_ms / 2:
        log(f"timed_ms: dispatching {reps} calls took {dispatch_ms:.3f} ms "
            f"against a {sleep_ms:.3f} ms sleep: the device time includes "
            "host work")
    return start.elapsed_time(end) / reps, call_ms


# bytes read between two calls of cold_ms: 2.5x the H100's 50 MB L2
FLUSH_BYTES = 128 << 20


def cold_ms(calls, rounds=5):
    """Device ms per call with the L2 cache flushed before each call: each
    of ``calls`` (callables) runs ``rounds`` times, after a read of
    FLUSH_BYTES that evicts its inputs, between two CUDA events; all of it
    queued behind a sleep on the card, so host dispatch drops out.  The
    warm times of ``timed_ms`` run a call back to back on inputs that may
    stay in L2 (50 MB), which a byte bound on HBM's rate does not see."""
    import torch
    scratch = torch.ones(FLUSH_BYTES // 4, device="cuda")
    for fn in calls:
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(rounds * len(calls))]

    def run():
        for (a, b), fn in zip(pairs, calls * rounds):
            scratch.sum()
            a.record()
            fn()
            b.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    sleep_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
    run()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


# the sleep kernel spins on the SM clock: cycles per ms at the H100's top
# clock (1.98 GHz), so that at a lower clock the sleep only lasts longer
SLEEP_CYCLES_PER_MS = 1_980_000
PROFILE_ATTEMPTS = 3


def profiled(body, setup=None):
    """(profiler, body's result) of ``body(setup())`` run under
    torch.profiler, CPU and CUDA activity, ending in a synchronize.  On
    the card the profiler has come back from a normal window with no
    device event at all; such a window is run again (``setup`` anew,
    outside the profiler), up to PROFILE_ATTEMPTS times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = body(arg) if setup is not None else body()
            torch.cuda.synchronize()
        if device_events(prof):
            return prof, out
        log(f"torch.profiler recorded no device activity (attempt "
            f"{attempt} of {PROFILE_ATTEMPTS})")
    raise AssertionError("torch.profiler recorded no device activity")


# the device kernels of each wrapper, by the name the profiler gives them
WRAPPER_KERNELS = {
    "sfc_keys": ("sfc_keys_kernel",),
    "ksection_hist": ("prep_kernel", "bucket_kernel"),
    "fem_matvec": ("element_pass", "vertex_pass"),
    "prefix_scan": ("scan_kernel",),
    "flash_attention": ("flash_kernel", "flash_tc_kernel"),
    "serve_prefill": ("packed_kernel", "packed_tc_kernel")}


def kernels_launched(launches):
    """Device kernels the wrappers launched, from their launch counts (a
    window's difference): fem_matvec and ksection_hist run two kernels a
    call, the others one."""
    out = dict(launches)
    for name in ("fem_matvec", "ksection_hist"):
        out[name] = 2 * launches.get(name, 0)
    return out


def wrapper_events(prof):
    """The profiler's kernel events per wrapper, by WRAPPER_KERNELS."""
    import re
    seen = {}
    for e in device_events(prof):
        for wrapper, kernels in WRAPPER_KERNELS.items():
            if any(re.search(rf"::{k}[<(]", e.name) for k in kernels):
                seen[wrapper] = seen.get(wrapper, 0) + 1
    return seen


def count_diff(after, before):
    return {k: after[k] - before.get(k, 0) for k in after}


def trace_summary(label, prof, wall_s, top_host=8, top_dev=5,
                  launches=None):
    """Device busy share of a profiled window, the host ops with the most
    self time and the device kernels with the most time.  With
    ``launches`` (the window's difference of ``ops.launch_counts``), each
    wrapper's kernel events beside the kernels its counts say it
    launched; where the profiler recorded fewer, it left kernels out of
    the window, and the idle share is printed as an upper bound."""
    from torch.autograd import DeviceType
    host, dev = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = dev.get(e.name, (0.0, 0))
            dev[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        elif e.device_type == DeviceType.CPU:
            t, c = host.get(e.name, (0.0, 0))
            host[e.name] = (t + e.self_cpu_time_total, c + 1)
    busy_s = sum(t for t, _ in dev.values()) / 1e6
    missing = False
    if launches is not None:
        want = kernels_launched(launches)
        seen = wrapper_events(prof)
        missing = any(seen.get(k, 0) < v for k, v in want.items())
        log(f"trace {label}: kernel events per wrapper "
            f"{ {k: seen.get(k, 0) for k in want} } against kernels "
            f"launched {want}")
    idle = 1 - busy_s / wall_s
    share = (f"idle share at most {idle:.4f} (the profiler missed kernels)"
             if missing else f"idle share {idle:.4f}")
    log(f"trace {label}: wall {wall_s:.4f} s, device busy {busy_s:.4f} s "
        f"(summed event durations), {share}")
    for kind, table, top in (("host self", host, top_host),
                             ("device", dev, top_dev)):
        for name, (t, c) in sorted(table.items(), key=lambda kv: -kv[1][0]
                                   )[:top]:
            log(f"  {kind} {t / 1e3:10.3f} ms  x{c:<6d} {name[:90]}")


def kernel_name(mangled):
    """A kernel's identifier and template arguments from its mangled name
    (an identifier ending in ``kernel``, after its length in digits)."""
    import re
    for m in re.finditer(r"kernel", mangled):
        end = m.end()
        for start in range(end - 6, 0, -1):
            for k in (1, 2, 3):
                digits = mangled[max(start - k, 0):start]
                if digits.isdigit() and int(digits) == end - start:
                    args = re.match(r"I\w*?E(?=E*v)", mangled[end:])
                    return mangled[start:end] + (args.group() if args
                                                 else "")
    return mangled[:60]


def kernel_resources(build_log):
    """One line a compiled kernel from nvcc's ``-Xptxas=-v`` output: the
    source, the kernel (``kernel_name``), registers, spill bytes and
    shared memory."""
    out, source, name, spill = [], "?", None, ""
    for line in build_log.splitlines():
        line = line.strip()
        if line.startswith("== "):
            source = line[3:].split(" ")[0]
        elif "Function properties for" in line:
            name = kernel_name(line.split("Function properties for ")[-1])
        elif "spill" in line:
            spill = line
        elif "Used" in line and "registers" in line and name:
            out.append(f"{source} {name}: {line.split(': ', 1)[-1]}; "
                       f"{spill}")
            name = None
    return out


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------

def run_session(dev, rounds=12, max_tets=3_000_000):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import BalanceSpec
    from repro_torch.fem import (AdaptSpec, AdaptiveSession, cylinder_mesh,
                                 uniform_refine)
    from repro_torch.kernels import ops
    from repro_torch.segment import SegmentOrder

    t0 = time.perf_counter()
    mesh = cylinder_mesh(8, 2, length=4.0, radius=0.5)
    uniform_refine(mesh, rounds)
    log(f"mesh: {mesh.n_tets} tets, {mesh.n_verts} verts (uniform_refine "
        f"x{rounds}, {time.perf_counter() - t0:.1f} s on the host)")
    check(mesh.n_tets == 192 << rounds, "initial mesh size")
    spec = AdaptSpec.for_problem(
        "helmholtz", max_steps=4, max_tets=max_tets, tol=1e-6,
        incremental=True,
        balance=BalanceSpec(p=64, method="hsfc", oneD="ksection"))
    per_step = []
    balanced = {}      # the last repartition's coordinates (kernel shapes)
    hook_s = [0.0]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    window, traces = {}, []
    builds = []

    def open_window():
        window["counts"] = ops.launch_counts()
        window["prof"] = profile(activities=acts)
        window["prof"].start()
        window["t0"] = time.perf_counter()

    def on_step(stats, state):
        t_hook = time.perf_counter()
        if state.step < TRACED_STEPS:
            torch.cuda.synchronize()
            window["prof"].stop()
            traces.append((state.step, window["prof"], t_hook - window["t0"],
                           count_diff(ops.launch_counts(), window["counts"])))
            window["prof"] = None
        per_step.append(dict(ops.launch_counts()))
        builds.append(SegmentOrder.builds)
        if state.repartitioned:
            balanced["coords"] = state.mesh.barycenters().astype(np.float32)
            balanced["step"] = state.step
        log(f"step {state.step}: n_tets={stats.n_tets} cg_iters="
            f"{stats.cg_iters} err_l2={stats.err_l2:.6e} imbalance="
            f"{stats.imbalance:.6f} t_solve={stats.t_solve:.4f}s "
            f"t_estimate={stats.t_estimate:.4f}s t_refine="
            f"{stats.t_refine:.4f}s t_balance={stats.t_balance:.4f}s "
            f"repartitioned={stats.repartitioned} rounds="
            f"{state.balance_result.ksection_rounds if state.balance_result else None}"
            f" keys={state.key_info['mode'] if state.key_info else None}"
            f"{' (traced)' if state.step < TRACED_STEPS else ''}")
        if state.step + 1 < TRACED_STEPS:
            open_window()
        hook_s[0] += time.perf_counter() - t_hook

    session = AdaptiveSession(spec, device=dev, on_step=on_step)
    ops.reset_launch_counts()
    SegmentOrder.builds = 0
    open_window()
    t0 = time.perf_counter()
    res = session.run(mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - hook_s[0]
    if window["prof"] is not None:      # fewer steps than TRACED_STEPS
        window["prof"].stop()
    counts = ops.launch_counts()
    log(f"session: {len(res.stats)} steps in {wall:.2f} s (without this "
        f"script's per-step hook), "
        f"{res.n_repartitions} repartitions; launches {counts}")
    prev = {k: 0 for k in counts}
    for i, c in enumerate(per_step):
        log(f"  launches in step {i}: "
            f"{ {k: c[k] - prev[k] for k in c} }; summation orders built "
            f"{builds[i] - (builds[i - 1] if i else 0)}")
        prev = c
    for step, prof, wall_s, launched in traces:
        trace_summary("session start to the end of step 0" if step == 0
                      else f"step {step}", prof, wall_s, launches=launched)
    for name in FEM_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "main path")
    errs = [s.err_l2 for s in res.stats]
    check(all(np.isfinite(e) for e in errs), "non-finite error")
    check(errs[-1] < errs[0], f"error did not fall under refinement: {errs}")
    check(all(s.imbalance < 1.01 for s in res.stats if s.repartitioned),
          "imbalance of a repartition above 1.01")
    check(res.u.shape == (res.mesh.n_verts,)
          and bool(res.u.isfinite().all()), "solution shape / finiteness")
    return res, session, counts, balanced


SMALL_RTOL = 1e-4      # err_l2 and total eta, card against CPU
TIE_RTOL = 1e-3        # an element marked on one side only is a tie


def small_session_agreement(dev):
    """The session with kernels on the card, twice, and against the plain
    versions on the CPU at the quickstart's smoke size (which the CPU
    tests hold against the JAX package), step by step on the card's own
    meshes.

    The card's sums add in an order fixed by the mesh, so the two card
    sessions must agree bit for bit at every step: n_tets, cg
    iterations, err_l2, every indicator and every mark.  The CPU sums in
    another order, and Dörfler marking sorts float32 indicators among
    which the cylinder mesh has many equal ones, so the CPU can mark
    another of several tied elements, after which two whole sessions
    refine different meshes.  So each step the card ran is replayed on
    the CPU, as a one-step session from a copy of the mesh that step
    solved on, and held to it: cg iterations within 2, err_l2 and total
    eta within SMALL_RTOL, and the same marked set up to ties (an element
    marked on one side only has the smallest marked indicator, within
    TIE_RTOL)."""
    import copy
    import numpy as np
    from repro_torch.core import BalanceSpec
    from repro_torch.fem import AdaptSpec, AdaptiveSession, cylinder_mesh
    spec = AdaptSpec.for_problem(
        "helmholtz", max_steps=3, max_tets=6000, tol=1e-6, incremental=True,
        balance=BalanceSpec(p=16, method="hsfc", oneD="ksection"))
    mesh = cylinder_mesh(8, 2, length=4.0, radius=0.5)
    solved_on, card = [copy.deepcopy(mesh)], []

    def keep(into, meshes=None):
        def on_step(stats, state):
            into.append((stats, state.marked.copy(), state.eta.copy()))
            if meshes is not None:      # the mesh the next step solves on
                meshes.append(copy.deepcopy(state.mesh))
        return on_step

    again = []
    AdaptiveSession(spec, device=dev, on_step=keep(card, solved_on)).run(
        copy.deepcopy(mesh))
    AdaptiveSession(spec, device=dev, on_step=keep(again)).run(mesh)
    check(len(card) == len(again), "small session: two card runs took "
          f"{len(card)} and {len(again)} steps")
    for step, ((sa, ma, ea), (sb, mb, eb)) in enumerate(zip(card, again)):
        same = ((sa.n_tets, sa.cg_iters, sa.err_l2, sa.eta)
                == (sb.n_tets, sb.cg_iters, sb.err_l2, sb.eta)
                and np.array_equal(ma, mb) and np.array_equal(ea, eb))
        check(same, f"small session step {step}: two card runs differ: "
              f"n_tets {sa.n_tets} / {sb.n_tets}, err_l2 {sa.err_l2!r} / "
              f"{sb.err_l2!r}, {int((ma != mb).sum())} marks and "
              f"{int((ea != eb).sum())} indicators differ")
        log(f"small session step {step}, card run twice: n_tets "
            f"{sa.n_tets}, cg_iters {sa.cg_iters}, err_l2 {sa.err_l2!r}, "
            f"{int(ma.sum())} marked: equal bit for bit")
    one_step = spec.replace(max_steps=1)
    for step, (sa, marked_a, _) in enumerate(card):
        cpu = []
        AdaptiveSession(one_step, device="cpu", on_step=keep(cpu)).run(
            solved_on[step])
        sb, marked_b, eta_b = cpu[0]
        check(abs(sa.cg_iters - sb.cg_iters) <= 2,
              f"small session step {step}: cg_iters {sa.cg_iters} vs "
              f"{sb.cg_iters}")
        for what, x, y in (("err_l2", sa.err_l2, sb.err_l2),
                           ("eta", sa.eta, sb.eta)):
            check(abs(x - y) <= SMALL_RTOL * abs(y),
                  f"small session step {step}: {what} {x} vs {y}")
        differ = np.flatnonzero(marked_a != marked_b)
        edge = eta_b[marked_b].min()
        check(np.all(np.abs(eta_b[differ] - edge) <= TIE_RTOL * edge),
              f"small session step {step}: marks differ beyond ties at "
              f"{differ.tolist()}")
        log(f"small session step {step}, card vs CPU on the card's mesh "
            f"({sb.n_tets} tets before refining): cg_iters {sa.cg_iters} "
            f"vs {sb.cg_iters}, err_l2 {sa.err_l2:.9e} vs {sb.err_l2:.9e}, "
            f"eta {sa.eta:.9e} vs {sb.eta:.9e}, marked "
            f"{int(marked_a.sum())} vs {int(marked_b.sum())}, "
            f"{differ.size} differ (ties)")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at main-path shapes
# ---------------------------------------------------------------------------

def pad_pow2(keys, w):
    import torch
    n = keys.shape[0]
    n_pad = 1 << max((max(n, 2) - 1).bit_length(), 1)
    if n_pad == n:
        return keys, w
    extra = n_pad - n
    return (torch.cat([keys, keys[-1:].expand(extra)]),
            torch.cat([w, w.new_zeros(extra)]))


def recorded_cuts(kf, w, p, warm=None):
    """Every cut array a k-section search on (kf, w) hands its histogram."""
    from repro_torch.core import partition1d
    from repro_torch.kernels import ref
    seq = []

    def rec(keys, weights, cuts):
        seq.append(cuts.clone())
        return ref.ksection_histogram_ref(keys, weights, cuts)
    partition1d.ksection(kf, w, p, k=8, iters=12, hist_fn=rec, warm=warm)
    return seq


def recorded_hist_inputs():
    """While the block runs, record every (keys, weights, cuts) the
    port's k-section histogram op is handed (the serving balancer's, at
    the shapes its path gives them); the op runs as before, so the
    launch counts stay the path's own."""
    from repro_torch.kernels import ops
    return recorded_calls(
        ops, "ksection_histogram_op",
        lambda keys, weights, cuts, **kw: tuple(
            t.detach().clone() for t in (keys, weights, cuts)))


@contextlib.contextmanager
def recorded_calls(module, name, keep):
    """While the block runs, ``module.name`` records ``keep(*args, **kw)``
    of each call and then runs as before (the launch counts stay the
    path's own)."""
    seen, fn = [], getattr(module, name)

    def rec(*args, **kw):
        seen.append(keep(*args, **kw))
        return fn(*args, **kw)
    setattr(module, name, rec)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def hist_agreement(seq):
    """The histogram kernel against its plain version on every recorded
    input on the card, as the op calls each (equal bits: integer
    weights): {inputs, equal, n, m} with the item and cut counts seen."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ksection_hist import ksection_hist_cuda
    f32, equal = torch.float32, True
    on_card = [x for x in seq if x[0].is_cuda]
    for keys, w, cuts in on_card:
        got = ksection_hist_cuda(keys.to(f32).contiguous(),
                                 w.to(f32).contiguous(),
                                 cuts.to(f32).contiguous())
        equal &= torch.equal(got, ref.ksection_histogram_ref(keys, w, cuts))
    return dict(inputs=len(on_card), equal=equal,
                n=sorted({int(x[0].shape[0]) for x in on_card}),
                m=sorted({int(x[2].shape[0]) for x in on_card}))


def check_hist_agreement(agree, launched, label):
    check(agree["inputs"] == launched,
          f"{label}: {agree['inputs']} histogram inputs on the card "
          f"against {launched} ksection_hist launches")
    check(agree["equal"], f"{label}: ksection_hist != its plain version "
          "at the balancer's shapes")
    log(f"{label}: ksection_hist against its plain version on each of the "
        f"path's {launched} inputs (items n in {agree['n']}, cuts m in "
        f"{agree['m']}): equal bit for bit")


def check_scan_agreement(inputs, launched, label):
    """The scan kernel against its plain version on every input the
    path's balancer handed ``exclusive_scan_op`` on the card (equal bits:
    integer weights sum exactly in float32)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefix_scan import exclusive_scan_cuda
    on_card = [x.to(torch.float32).contiguous() for x in inputs if x.is_cuda]
    check(len(on_card) == launched, f"{label}: {len(on_card)} scan inputs "
          f"on the card against {launched} prefix_scan launches")
    check(all(torch.equal(exclusive_scan_cuda(x), ref.exclusive_scan_ref(x))
              for x in on_card),
          f"{label}: prefix_scan != its plain version at the path's shapes")
    log(f"{label}: prefix_scan against its plain version on each of the "
        f"path's {launched} inputs (n in "
        f"{sorted({int(x.shape[0]) for x in on_card})}): equal bit for bit")


def compare_sfc(coords_np, dev):
    import torch
    from repro_torch.core.sfc import bounding_box, box_map
    from repro_torch.kernels import ref
    from repro_torch.kernels.sfc_keys import sfc_keys_cuda
    coords = torch.as_tensor(coords_np, device=dev)
    lo, hi = bounding_box(coords)
    grid = box_map(coords, lo, hi).to(torch.int32).contiguous()
    n = grid.shape[0]
    row = None
    for curve in ("hilbert", "morton"):
        plain = ref.hilbert_keys_ref if curve == "hilbert" else ref.morton_keys_ref
        got = sfc_keys_cuda(grid, curve=curve).to(torch.int64)
        want = plain(grid)
        check(torch.equal(got, want), f"sfc_keys {curve}: kernel != plain")
        ms, call_ms = timed_ms(lambda: sfc_keys_cuda(grid, curve=curve))
        cold = cold_ms([lambda: sfc_keys_cuda(grid, curve=curve)], rounds=20)
        plain_ms, plain_call_ms = timed_ms(lambda: plain(grid), reps=5)
        bound = 16 * n / PEAK_BYTES_PER_S * 1e3
        log(f"sfc_keys[{curve}] n={n}: kernel_ms={ms:.4f} (call "
            f"{call_ms:.4f}; L2 flushed {cold:.4f}) plain_ms={plain_ms:.4f} "
            f"(call {plain_call_ms:.4f}) bound_ms={bound:.4f} share warm "
            f"{bound / ms:.4f}, L2 flushed {bound / cold:.4f} equal=True")
        if curve == "hilbert":   # the main path's curve (method hsfc)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by="bytes", library_ms=None, max_abs_err=0.0)
    sfc_every_point(dev)
    counts = key_instructions()
    log(f"sfc_keys integer instructions a key costs (SASS of "
        f"{os.path.relpath(SFC_SOURCE, ROOT)}, bits = 10): {counts}")
    return row, coords, lo, hi


SFC_CHUNK_BITS = 24     # points per chunk of the every-point check: 2^24


def sfc_every_point(dev, bits=10):
    """Both curves' keys from the kernel against the plain version on
    every point of the 2^bits grid (2^30 at bits = 10), 2^24 points a
    chunk."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.sfc_keys import sfc_keys_cuda
    side = 1 << bits
    chunk = 1 << SFC_CHUNK_BITS
    for curve in ("hilbert", "morton"):
        plain = ref.hilbert_keys_ref if curve == "hilbert" else ref.morton_keys_ref
        sync(dev)
        t0 = time.perf_counter()
        for start in range(0, side ** 3, chunk):
            i = torch.arange(start, start + chunk, device=dev,
                             dtype=torch.int32)
            g = torch.stack([i // (side * side), (i // side) % side,
                             i % side], dim=1).contiguous()
            check(torch.equal(sfc_keys_cuda(g, curve=curve, bits=bits).long(),
                              plain(g, bits)),
                  f"sfc_keys {curve}: kernel != plain on points "
                  f"[{start}, {start + chunk})")
        sync(dev)
        log(f"sfc_keys[{curve}] every point of the 2^{bits} grid "
            f"({side ** 3} points, {side ** 3 // chunk} chunks): equal to "
            f"the plain version, {time.perf_counter() - t0:.2f} s")


SFC_SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                          "sfc_keys.cu")
# integer ALU opcodes of the SASS (Hopper), for key_instructions
INT_OPS = ("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "IMAD",
           "LEA", "ISETP", "SEL", "PRMT", "BFE", "BFI", "IABS", "IMNMX",
           "VIADD", "VIMNMX", "FLO", "POPC", "BREV", "IMUL", "ICMP", "PLOP3",
           "MOV", "P2R", "R2P")


def key_instructions():
    """Integer instructions one key costs in ``csrc/sfc_keys.cu``, per
    curve at bits = 10, from the SASS of a probe kernel that includes the
    source and computes one key a thread from a loaded (x, y, z): the
    probe's integer instructions minus those of the same probe that only
    stores x ^ y ^ z.  The Hilbert walk's table lookups count apart
    (``loads``, beyond the probe's three)."""
    import re
    import shutil
    import tempfile
    from repro_torch.kernels import build
    probe = f"""#include "{SFC_SOURCE}"
namespace {{
__global__ void probe_base(const unsigned* in, unsigned* out) {{
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned x = in[3 * i], y = in[3 * i + 1], z = in[3 * i + 2];
  out[i] = x ^ y ^ z;
}}
__global__ void probe_morton(const unsigned* in, unsigned* out) {{
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned x = in[3 * i], y = in[3 * i + 1], z = in[3 * i + 2];
  out[i] = morton_key(x, y, z);
}}
__global__ void probe_hilbert(const unsigned* in, unsigned* out,
                              const unsigned short* tab) {{
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned x = in[3 * i], y = in[3 * i + 1], z = in[3 * i + 2];
  out[i] = hilbert_key<5>(x, y, z, tab, 0u);
}}
}}
void* probe_keep[] = {{(void*)probe_base, (void*)probe_morton,
                      (void*)probe_hilbert}};
"""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=build.BUILD_DIR)
    try:
        src = os.path.join(work, "probe.cu")
        with open(src, "w") as f:
            f.write(probe)
        cubin = os.path.join(work, "probe.cubin")
        nvcc = build.nvcc()
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-cubin", src, "-o", cubin],
                       check=True, capture_output=True, text=True)
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"probe_(base|morton|hilbert)", line)
            current = m.group(1) if m else None
            if current:
                counts[current] = {"int": 0, "loads": 0}
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                       line)
        if current and op:
            if op.group(1) in INT_OPS:
                counts[current]["int"] += 1
            if op.group(1).startswith("LD"):
                counts[current]["loads"] += 1
    base = counts["base"]
    return {curve: {k: counts[curve][k] - base[k] for k in base}
            for curve in ("morton", "hilbert")}


def compare_hist(kf, w, p, label, faster=False):
    """The histogram kernel against its plain version on every cut array
    of a k-section search on (kf, w) at p parts (equal bits: integer
    weights), timed per call; ``faster``: fail unless the kernel beats
    its plain version."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ksection_hist import ksection_hist_cuda
    seq = recorded_cuts(kf, w, p)
    for c in seq:
        got = ksection_hist_cuda(kf, w, c)
        want = ref.ksection_histogram_ref(kf, w, c)
        check(torch.equal(got, want), f"ksection_hist {label}: kernel != plain")
    ms, call_ms = timed_ms(lambda: [ksection_hist_cuda(kf, w, c)
                                    for c in seq], reps=5)
    cold = cold_ms([lambda c=c: ksection_hist_cuda(kf, w, c) for c in seq])
    plain_ms, plain_call_ms = timed_ms(
        lambda: [ref.ksection_histogram_ref(kf, w, c) for c in seq], reps=5)
    before = ksection_hist_cuda.launches
    prof, _ = profiled(lambda: [ksection_hist_cuda(kf, w, c) for c in seq])
    launches = ksection_hist_cuda.launches - before
    events = wrapper_events(prof).get("ksection_hist", 0)
    r = len(seq)
    ms, call_ms, plain_ms, plain_call_ms = (
        ms / r, call_ms / r, plain_ms / r, plain_call_ms / r)
    n, m = kf.shape[0], seq[0].shape[0]
    # least work: stream keys and weights once, read the cuts, write the
    # sums; each item found among the sorted cuts by binary search
    t_bytes = (8 * n + 8 * m) / PEAK_BYTES_PER_S * 1e3
    t_ops = n * math.ceil(math.log2(m + 1)) / PEAK_FP32_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"ksection_hist[{label}] n={n} m={m} rounds={r}: kernel_ms="
        f"{ms:.4f} (call {call_ms:.4f}; L2 flushed {cold:.4f}) plain_ms="
        f"{plain_ms:.4f} (call {plain_call_ms:.4f}) bound_ms={bound:.4f} "
        f"({by}; bytes {t_bytes:.4f}, ops {t_ops:.4f}) share warm "
        f"{bound / ms:.4f}, L2 flushed {bound / cold:.4f} equal=True per "
        f"call; launches a call {launches / r:g}, kernel events a call "
        f"(profiler) {events / r:g}")
    if faster:
        check(ms < plain_ms, f"ksection_hist {label}: the kernel "
              f"({ms:.4f} ms) is not faster than its plain version "
              f"({plain_ms:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, max_abs_err=0.0)


MATVEC_CALLS_PER_SOLVE = 160    # ~the session's PCG iterations per solve


def compare_matvec(mesh, dev):
    """The plan kernel at the session's last mesh: against its plain
    version (1e-5 of max|y|), bit-identical across calls, its plan's
    build time, the bound of the old 80 B/element + 8 B/vertex, and a CSR
    SpMV as the yardstick."""
    import numpy as np
    import torch
    from repro_torch.fem import build_elements
    from repro_torch.kernels import ElementOperator, ref
    from repro_torch.kernels.fem_matvec import (fem_element_matrices,
                                                fem_matvec_cuda)
    el = build_elements(mesh.verts, mesh.tets, device=dev)
    kel = fem_element_matrices(el.grads, el.vol, 1.0).contiguous()
    tets = el.tets.contiguous()
    C, V = tets.shape[0], el.n_verts
    g = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand(V, generator=g, device=dev, dtype=torch.float32)
    ElementOperator(tets, kel, V)                  # warm the sorts
    builds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op = ElementOperator(tets, kel, V)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0) * 1e3)
    build_ms = float(np.median(builds))
    got = op.apply(u)
    want = ref.fem_matvec_kel_ref(tets, kel, u, V)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= 1e-5 * scale, f"fem_matvec: max err {err} > 1e-5 * {scale}")
    check(torch.equal(got, op.apply(u)), "fem_matvec: two calls differ")
    check(torch.equal(got, fem_matvec_cuda(tets, kel, u, V)),
          "fem_matvec: a fresh plan gives other bits")
    ms, call_ms = timed_ms(lambda: op.apply(u))
    plain_ms, plain_call_ms = timed_ms(
        lambda: ref.fem_matvec_kel_ref(tets, kel, u, V), reps=5)
    # yardstick: the assembled operator as one cuSPARSE CSR product
    t = tets.long()
    rows = t[:, :, None].expand(C, 4, 4).reshape(-1)
    cols = t[:, None, :].expand(C, 4, 4).reshape(-1)
    A = torch.sparse_coo_tensor(torch.stack([rows, cols]), kel.reshape(-1),
                                (V, V)).coalesce().to_sparse_csr()
    lib_ms, lib_call_ms = timed_ms(lambda: A @ u)
    lib_err = float(((A @ u) - want).abs().max())
    del A, rows, cols
    bound = (80 * C + 8 * V) / PEAK_BYTES_PER_S * 1e3
    n = MATVEC_CALLS_PER_SOLVE
    log(f"fem_matvec C={C} V={V}: kernel_ms={ms:.4f} (call {call_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} (call {plain_call_ms:.4f}) csr_spmv_ms="
        f"{lib_ms:.4f} (call {lib_call_ms:.4f}) bound_ms={bound:.4f} "
        f"(80 B/element + 8 B/vertex) share={bound / ms:.4f} "
        f"max_abs_err={err:.3e} (tolerance 1e-5 * max|y| = "
        f"{1e-5 * scale:.3e}; csr err {lib_err:.3e}); bit-identical over "
        f"two calls and a fresh plan")
    log(f"fem_matvec plan: build_ms={build_ms:.4f} (runs {builds}); "
        f"partials {op.plan.n_partials} ({op.plan.n_partials / C:.4f} per "
        f"element); per solve of {n} calls: plan {build_ms:.3f} + {n} x "
        f"{call_ms:.4f} = {build_ms + n * call_ms:.3f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=lib_ms, max_abs_err=err)


def compare_sums(mesh, dev):
    """The FEM's fixed-order segment sum at the last mesh (4 contributions
    per tet into the vertices, as the load vector and diagonal add them):
    its time against index_add_'s atomics on the same data, and the
    largest difference between the two relative to max|sum|."""
    import torch
    from repro_torch.fem import build_elements
    from repro_torch.segment import (SegmentOrder, segment_sum,
                                     segment_sum_any_order)
    el = build_elements(mesh.verts, mesh.tets, device=dev)
    ids = el.tets.reshape(-1)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.repeat_interleave(el.vol, 4) * torch.rand(
        ids.numel(), generator=g, device=dev)
    fixed = segment_sum(x, ids, el.n_verts)
    kept = segment_sum(x, ids, el.n_verts, el.order)
    check(torch.equal(fixed, segment_sum(x, ids, el.n_verts)),
          "segment_sum: two calls differ on the card")
    check(torch.equal(fixed, kept), "segment_sum: the mesh's kept order "
          "gives other bits than a fresh one")
    atomic = segment_sum_any_order(x, ids, el.n_verts)
    rel = float((fixed - atomic).abs().max() / atomic.abs().max())
    ms, call_ms = timed_ms(lambda: segment_sum(x, ids, el.n_verts), reps=5)
    kept_ms, kept_call = timed_ms(
        lambda: segment_sum(x, ids, el.n_verts, el.order), reps=5)
    build_ms, _ = timed_ms(lambda: SegmentOrder(ids, el.n_verts), reps=5)
    any_ms, any_call = timed_ms(
        lambda: segment_sum_any_order(x, ids, el.n_verts), reps=5)
    log(f"segment_sum fixed order, {ids.numel()} contributions into "
        f"{el.n_verts} vertices: on the mesh's kept order device "
        f"{kept_ms:.4f} ms (call {kept_call:.4f}); building an order "
        f"every call {ms:.4f} (call {call_ms:.4f}), of which the build "
        f"{build_ms:.4f}, {len(el.order.steps)} tree steps; index_add_ "
        f"{any_ms:.4f} (call {any_call:.4f}); bit-identical over two calls "
        f"and on the kept order; max |fixed - index_add_| / max|sum| = "
        f"{rel:.3e}")


# ---------------------------------------------------------------------------
# phases 4-5: balance with kernels against plain versions
# ---------------------------------------------------------------------------

def results_equal(a, b):
    import torch
    fields = ("parts", "part_weights", "imbalance", "total_v", "max_v",
              "retained", "remap_perm", "splitters")
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            return f
    if a.ksection_rounds != b.ksection_rounds:
        return "ksection_rounds"
    return None


def balance_pair(spec, dev, **kw):
    from repro_torch.core import Balancer
    rk, tk = Balancer(spec, device=dev).balance_timed(**kw)
    rp, tp = Balancer(spec.replace(use_pallas=False), device=dev
                      ).balance_timed(**kw)
    bad = results_equal(rk, rp)
    check(bad is None, f"balance {spec.method}/{spec.oneD}: field {bad} "
          "differs between kernels and plain versions")
    return rk, tk["t_balance"], tp["t_balance"]


def replay_balance(res, session, dev):
    import numpy as np
    import torch
    mesh = res.mesh
    w = torch.ones(mesh.n_tets, dtype=torch.float32, device=dev)
    coords = mesh.barycenters().astype(np.float32)
    old = mesh.leaf_payload["parts"]
    for oneD in ("ksection", "sorted"):
        spec = session.balance_spec.replace(oneD=oneD, warm_start=False)
        r, tk, tp = balance_pair(spec, dev, weights=w, coords=coords,
                                 old_parts=old)
        log(f"replay {spec.method}/{oneD} on the last mesh (n={mesh.n_tets}):"
            f" equal=True imbalance={float(r.imbalance):.6f} "
            f"t_kernels={tk:.4f}s t_plain={tp:.4f}s")


def standalone_dlb(dev, n=8_000_000):
    import numpy as np
    import torch
    from repro_torch.core import BalanceSpec
    from repro_torch.core.sfc import bounding_box, sfc_keys
    rng = np.random.default_rng(0)
    coords = torch.as_tensor(
        (rng.random((n, 3)) * np.array([10.0, 1.0, 1.0])).astype(np.float32),
        device=dev)
    w = torch.as_tensor(rng.integers(1, 3, n).astype(np.float32), device=dev)
    for method in ("hsfc", "msfc"):
        for oneD in ("sorted", "ksection"):
            spec = BalanceSpec(p=1024, method=method, oneD=oneD)
            balance_pair(spec, dev, weights=w, coords=coords)   # warm-up
            r, tk, tp = balance_pair(spec, dev, weights=w, coords=coords)
            log(f"dlb {method}/{oneD} n={n} p=1024: equal=True imbalance="
                f"{float(r.imbalance):.6f} t_kernels={tk:.4f}s "
                f"t_plain={tp:.4f}s rounds={r.ksection_rounds}")
    lo, hi = bounding_box(coords)
    keys = sfc_keys(coords, lo, hi).to(torch.float32)
    kf, wf = pad_pow2(keys, w)
    return compare_hist(kf.contiguous(), wf.contiguous(), 1024, "p=1024",
                        faster=True)


# ---------------------------------------------------------------------------
# phases 10-12: the multi-device layer (main path 3)
# ---------------------------------------------------------------------------

SHARDED_P = 4
PROFILED_STEP = 1       # the sharded session step run under torch.profiler
# beside the shard lengths the sharded session scanned: 2^21, the FEM
# session's largest mesh and a ragged n
SCAN_EXTRA_SIZES = (1 << 21, 2_588_188, 1_000_003)
PCG_RTOL = 1e-5         # owned PCG against the replicated-layout solve


def sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def rank_placement():
    """NCCL with one rank per card where there are enough cards; else
    the ranks share cuda:0 and their collectives go through gloo, staged
    through host memory."""
    import torch
    if torch.cuda.device_count() >= SHARDED_P:
        return "nccl", [f"cuda:{r}" for r in range(SHARDED_P)]
    return "gloo", ["cuda:0"] * SHARDED_P


def start_world(fn, *args, join_s):
    """``fn(comm, *args)`` on SHARDED_P ranks placed by rank_placement;
    a file rendezvous under build/ (no network port)."""
    import torch
    from repro_torch.distributed import run_world
    backend, devices = rank_placement()
    rdv_dir = os.path.join(ROOT, "build", "rendezvous")
    os.makedirs(rdv_dir, exist_ok=True)
    init = os.path.join(rdv_dir, f"{fn.__name__}-{os.getpid()}-"
                                 f"{time.monotonic_ns()}")
    log(f"ranks: {SHARDED_P} over {backend} on {devices} "
        f"(torch.cuda.device_count()={torch.cuda.device_count()}; card "
        f"{nvidia_smi_line()})")
    try:
        return run_world(fn, SHARDED_P, *args, backend=backend,
                         devices=devices, init_file=init, timeout_s=600.0,
                         join_s=join_s), backend
    finally:
        if os.path.exists(init):
            os.remove(init)


def compare_scan(dev, path_lengths):
    """Phase 12: the prefix-scan kernel against its plain version
    (torch.cumsum(x) - x) at every shard length the sharded session's
    sorted stage scanned (a rank's C = Balancer.capacity_for(n_tets), as
    recorded by phase 11), then at SCAN_EXTRA_SIZES: integer weights
    equal, uniform floats within 1e-6 * sum|x| and the same bits over
    three more calls; timed beside torch.cumsum alone (the library
    yardstick), device and call times side by side.  The table row is
    the length the path scanned most often."""
    import collections
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefix_scan import exclusive_scan_cuda
    freq = collections.Counter(path_lengths)
    row_n = max(freq, key=lambda n: (freq[n], n))
    log(f"shard lengths the sharded session scanned (per rank, each "
        f"balance): {path_lengths}; table row at n={row_n}")
    row = None
    for n in sorted(freq) + [n for n in SCAN_EXTRA_SIZES if n not in freq]:
        rng = np.random.default_rng(n)
        xi = torch.as_tensor(rng.integers(1, 3, n).astype(np.float32),
                             device=dev)
        check(torch.equal(exclusive_scan_cuda(xi), ref.exclusive_scan_ref(xi)),
              f"prefix_scan n={n}: integer weights differ")
        xf = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
        got = exclusive_scan_cuda(xf)
        want = ref.exclusive_scan_ref(xf)
        err = float((got - want).abs().max())
        tol = 1e-6 * float(xf.abs().sum())
        check(err <= tol, f"prefix_scan n={n}: float err {err} > {tol}")
        check(all(torch.equal(got, exclusive_scan_cuda(xf))
                  for _ in range(3)), f"prefix_scan n={n}: not deterministic")
        ms, call_ms = timed_ms(lambda: exclusive_scan_cuda(xf))
        plain_ms, plain_call_ms = timed_ms(lambda: ref.exclusive_scan_ref(xf))
        lib_ms, lib_call_ms = timed_ms(lambda: torch.cumsum(xf, dim=0))
        bound = 8 * n / PEAK_BYTES_PER_S * 1e3
        where = (f"path, {freq[n]} scan(s) per rank" if n in freq
                 else "extra size")
        log(f"prefix_scan n={n} ({where}): kernel_ms={ms:.4f} (call "
            f"{call_ms:.4f}) plain_ms={plain_ms:.4f} (call "
            f"{plain_call_ms:.4f}) cumsum_ms={lib_ms:.4f} (call "
            f"{lib_call_ms:.4f}) bound_ms={bound:.4f} share={bound / ms:.3f} "
            f"max_abs_err={err:.3e} (tolerance 1e-6 * sum|x| = {tol:.3e}); "
            f"integers equal; against torch.cumsum: "
            f"device {ms / lib_ms:.3f}x, call {call_ms / lib_call_ms:.3f}x")
        if n == row_n:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by="bytes", library_ms=lib_ms, max_abs_err=err)
    return row


BALANCE_FIELDS = ("parts", "part_weights", "imbalance", "total_v",
                            "max_v", "retained", "remap_perm")


def same_balance(a, b, oneD):
    import torch
    fields = BALANCE_FIELDS + (
        ("splitters",) if oneD == "ksection" else ())
    for f in fields:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            return f
    if a.ksection_rounds != b.ksection_rounds:
        return "ksection_rounds"
    return None


def sharded_dlb_rank(comm, n, seed):
    """One rank of the standalone sharded DLB step: 8M seeded points,
    integer weights, hsfc; the old partition is the host balance at unit
    weights.  Each oneD runs once to warm up, then timed; the result is
    held against the host backend on the same card."""
    import numpy as np
    import torch
    from repro_torch.core import Balancer, BalanceSpec
    from repro_torch.kernels import ops
    dev = comm.device
    rng = np.random.default_rng(seed)
    coords = torch.as_tensor((rng.random((n, 3)) * np.array([10.0, 1.0, 1.0])
                              ).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.integers(1, 3, n).astype(np.float32), device=dev)
    old = Balancer(BalanceSpec(p=SHARDED_P, method="hsfc"), device=dev
                   ).balance(torch.ones_like(w), coords=coords).parts
    out = {}
    for oneD in ("sorted", "ksection"):
        spec = BalanceSpec(p=SHARDED_P, method="hsfc", oneD=oneD,
                           backend="sharded", execute_migration=True)
        b = Balancer(spec, comm=comm)
        b.balance(w, coords=coords, old_parts=old)          # warm-up
        staged0 = comm.staged_bytes
        ops.reset_launch_counts()
        r, t = b.balance_timed(w, coords=coords, old_parts=old)
        counts = ops.launch_counts()
        staged = comm.staged_bytes - staged0
        t_max = float(comm.pmax(torch.tensor(t["t_balance"], device=dev)))
        host = Balancer(spec.replace(backend="host"), device=dev).balance(
            w, coords=coords, old_parts=old)
        mig = {k: float(v) for k, v in r.migration.items()}
        out[oneD] = dict(
            t_balance=t["t_balance"], t_balance_max=t_max,
            differs=same_balance(r, host, oneD), migration=mig,
            imbalance=float(r.imbalance), total_v=float(r.total_v),
            rounds=r.ksection_rounds, launches=counts, staged_bytes=staged)
    return out


def sharded_dlb(n=8_000_000):
    """Phase 10: the standalone sharded DLB step over SHARDED_P ranks."""
    (outs, backend) = start_world(sharded_dlb_rank, n, 0, join_s=900.0)
    for oneD in ("sorted", "ksection"):
        rs = [o[oneD] for o in outs]
        for r, o in enumerate(rs):
            check(o["differs"] is None, f"sharded dlb {oneD} rank {r}: field "
                  f"{o['differs']} differs from the host backend")
            m = o["migration"]
            check(m["weight_in"] == m["weight_out"] and m["overflow"] == 0
                  and m["items"] == n, f"sharded dlb {oneD}: migration {m}")
        log(f"sharded dlb hsfc/{oneD} n={n} p={SHARDED_P} ({backend}): "
            f"equal to the host backend on every rank; t_balance max over "
            f"ranks {rs[0]['t_balance_max']:.4f} s (per rank "
            f"{[round(o['t_balance'], 4) for o in rs]}); imbalance="
            f"{rs[0]['imbalance']:.6f} TotalV={rs[0]['total_v']:.0f} "
            f"rounds={rs[0]['rounds']} migration={rs[0]['migration']}; "
            f"host-staged bytes per rank {rs[0]['staged_bytes']}; launches "
            f"rank 0 {rs[0]['launches']}")


def replicated_layout_solve(comm, problem, spec, kept):
    """The replicated-layout solve of a kept solve's packing: the same
    masked system, PCG over the replicated vertex vector with one psum
    per matvec (fem.parallel's replicated layout).  Also says whether
    this rank's load vector equals rank 0's bit for bit."""
    import torch
    from repro_torch.fem import load_vector
    from repro_torch.fem.parallel import (make_sharded_matvec,
                                          shard_elements_on_device,
                                          sharded_diagonal)
    from repro_torch.fem.solve import pcg
    el, verts, free = kept["el"], kept["verts"], kept["free"]
    sel = shard_elements_on_device(el, kept["parts"], SHARDED_P, comm)
    mv, _ = make_sharded_matvec(sel, comm, problem.c)
    # rank 0's right-hand side on every rank, as the session does, so
    # every rank's PCG takes the same iterations; the fixed-order sums
    # should make every rank's own copy equal to it already
    own = load_vector(el, verts, problem.f)
    rhs = comm.broadcast(own)
    g = problem.exact(verts)
    zero = torch.zeros((), device=rhs.device)
    g_ext = torch.where(free > 0, zero, g)
    b = torch.where(free > 0, rhs - mv(g_ext), zero)
    diag = torch.where(free > 0, sharded_diagonal(sel, comm, problem.c),
                       torch.ones_like(free))
    res = pcg(lambda u: torch.where(free > 0, mv(u * free), u), b, diag,
              torch.zeros_like(b), tol=spec.tol, maxiter=spec.maxiter)
    return res.x + g_ext, res.iters, bool(torch.equal(own, rhs))


def sharded_session_rank(comm, rounds, max_tets):
    """One rank of the sharded adaptive session (main path 3): the host
    session's mesh, owned layout, repartition and migration every step.
    The session runs once with the launch counts from 0; its public
    ``on_state`` observer keeps, after each stage, copies of what the
    checks read.  After the counted run every step is checked: its
    partition against the host backend on the same mesh, its owned PCG
    solution against the replicated-layout solve of the same packing,
    and the migration to conservation.  Also returns the shard length
    each balance's sorted stage scanned (Balancer.capacity_for)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Balancer, BalanceSpec
    from repro_torch.fem import (AdaptSpec, AdaptiveSession, cylinder_mesh,
                                 uniform_refine)
    from repro_torch.fem.adapt import free_mask
    from repro_torch.kernels import ops
    from repro_torch.segment import SegmentOrder
    dev = comm.device
    t0 = time.perf_counter()
    mesh = cylinder_mesh(8, 2, length=4.0, radius=0.5)
    uniform_refine(mesh, rounds)
    t_mesh = time.perf_counter() - t0
    spec = AdaptSpec.for_problem(
        "helmholtz", max_steps=3, max_tets=max_tets, tol=1e-6,
        backend="sharded", vertex_layout="owned", trigger="always",
        balance=BalanceSpec(p=SHARDED_P, method="hsfc", oneD="sorted"))
    kept = []               # per step: what its solve and balance left
    scanned = []            # shard length of each balance's scan
    seen = {"result": None, "inherited": None}
    window = {}

    def on_state(stage, state):
        br = state.balance_result
        if br is not None and br is not seen["result"]:
            seen["result"] = br
            scanned.append(session.balancer.capacity_for(state.mesh.n_tets))
        m = state.mesh
        if stage == "solve":
            kept.append({"solve": dict(
                el=state.el, u=state.u.clone(),
                parts=np.asarray(m.leaf_payload["parts"]).copy(),
                verts=torch.as_tensor(m.verts.astype(np.float32),
                                      device=dev),
                free=free_mask(m, dev))})
        elif stage == "adapt_mesh":     # the parts refinement handed down
            inh = m.leaf_payload.get("parts")
            seen["inherited"] = None if inh is None else np.array(inh)
        elif stage == "balance":
            kept[-1]["balance"] = dict(
                result=br, inherited=seen["inherited"], n=m.n_tets,
                coords=m.barycenters().astype(np.float32),
                packed=(state.sharded.vol > 0).sum())

    builds = []             # summation orders built, per step

    def on_step(stats, state):
        builds.append(SegmentOrder.builds)
        if state.step == PROFILED_STEP:
            sync(dev)
            window["prof"].stop()
            window["wall"] = time.perf_counter() - window["t0"]
            window["counts"] = count_diff(ops.launch_counts(),
                                          window["counts"])
        if state.step + 1 == PROFILED_STEP:
            sync(dev)
            window["counts"] = ops.launch_counts()
            window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()

    session = AdaptiveSession(spec, comm=comm, on_step=on_step,
                              on_state=on_state)
    sync(dev)
    staged0 = comm.staged_bytes
    ops.reset_launch_counts()
    SegmentOrder.builds = 0
    t0 = time.perf_counter()
    res = session.run(mesh)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    staged = comm.staged_bytes - staged0
    check(res.u.shape == (res.mesh.n_verts,), "solution shape")
    check(len(kept) == len(res.stats), "one kept solve per step")
    busy = sum(e.time_range.elapsed_us() for e in
               device_events(window["prof"])) / 1e6
    if comm.rank == 0:
        trace_summary(f"rank 0, step {PROFILED_STEP} of the sharded session",
                      window["prof"], window["wall"],
                      launches=window["counts"])

    # the checks, after the counted run
    t_max = comm.pmax(torch.tensor(
        [[s.t_solve, s.t_estimate, s.t_refine, s.t_balance]
         for s in res.stats], device=dev)).tolist()
    host = Balancer(session.balance_spec.replace(backend="host"), device=dev)
    steps = []
    for step, (stats, k) in enumerate(zip(res.stats, kept)):
        x, iters, rhs_equal = replicated_layout_solve(
            comm, session.problem, spec, k["solve"])
        scale = float(x.abs().max())
        err = float((k["solve"]["u"] - x).abs().max()) / scale
        check(np.isfinite(stats.err_l2), f"step {step}: non-finite error")
        check(err <= PCG_RTOL, f"step {step}: owned PCG differs from the "
              f"replicated-layout solve by {err:.3e} relative (> {PCG_RTOL})")
        b = k["balance"]
        n = b["n"]
        want = host.balance(torch.ones(n, dtype=torch.float32, device=dev),
                            coords=b["coords"], old_parts=b["inherited"])
        bad = same_balance(b["result"], want, "sorted")
        check(bad is None, f"step {step}: field {bad} differs from the host "
              "backend on the same mesh")
        mig = {key: float(v) for key, v in b["result"].migration.items()}
        n_packed = int(comm.psum(b["packed"]))
        check(mig["weight_in"] == mig["weight_out"] == n
              and mig["overflow"] == 0 and n_packed == n,
              f"step {step}: migration {mig}, {n_packed} packed of {n}")
        steps.append(dict(
            n_tets=stats.n_tets, n_tets_balanced=n,
            imbalance=stats.imbalance, total_v=stats.migration_totalv,
            cut=stats.cut, halo_bytes=stats.comm_halo_bytes,
            psum_bytes=stats.comm_psum_bytes, cg_iters=stats.cg_iters,
            rep_iters=int(iters), pcg_err=err, err_l2=stats.err_l2,
            rhs_equal=rhs_equal, builds=builds[step] - (
                builds[step - 1] if step else 0),
            t_max=t_max[step], migration=mig))
    return dict(steps=steps, launches=launches, scanned=scanned, wall=wall,
                t_mesh=t_mesh, staged_bytes=staged, n_tets0=192 << rounds,
                busy_s=busy, window_s=window["wall"])


def sharded_session(rounds=12, max_tets=3_000_000):
    """Phase 11: the sharded adaptive session (main path 3)."""
    outs, backend = start_world(sharded_session_rank, rounds, max_tets,
                                join_s=1000.0)
    r0 = outs[0]
    for r, o in enumerate(outs):
        check([s["n_tets"] for s in o["steps"]]
              == [s["n_tets"] for s in r0["steps"]],
              f"rank {r} refined another mesh")
        check(o["scanned"] == r0["scanned"], f"rank {r} scanned other "
              "shard lengths")
        check(all(s["rhs_equal"] for s in o["steps"]), f"rank {r}'s own "
              "load vector differs from rank 0's in some step")
    for step, s in enumerate(r0["steps"]):
        t = s["t_max"]
        log(f"sharded step {step}: n_tets={s['n_tets']} (balanced "
            f"{s['n_tets_balanced']}) imbalance={s['imbalance']:.6f} "
            f"TotalV={s['total_v']:.0f} cut={s['cut']} halo_bytes="
            f"{s['halo_bytes']} psum_bytes={s['psum_bytes']} cg_iters="
            f"{s['cg_iters']} (replicated layout {s['rep_iters']}) err_l2="
            f"{s['err_l2']:.6e} owned-vs-replicated {s['pcg_err']:.3e}; max "
            f"over ranks: t_solve={t[0]:.4f}s t_estimate={t[1]:.4f}s "
            f"t_refine={t[2]:.4f}s t_balance={t[3]:.4f}s; migration "
            f"{s['migration']}; every rank's own load vector equal to "
            f"rank 0's bit for bit; summation orders built on rank 0 "
            f"{s['builds']} (none per PCG iteration)")
    launches = {k: sum(o["launches"][k] for o in outs) for k in r0["launches"]}
    for name in ("sfc_keys", "fem_matvec", "prefix_scan"):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              "sharded session's path")
    log(f"sharded session ({backend}): initial mesh {r0['n_tets0']} tets "
        f"(built on every rank in {max(o['t_mesh'] for o in outs):.1f} s), "
        f"{len(r0['steps'])} steps in {max(o['wall'] for o in outs):.2f} s "
        f"(max over ranks; the checks run after); host-staged bytes per "
        f"rank {[o['staged_bytes'] for o in outs]}; path launches summed "
        f"over ranks {launches}")
    busy = sum(o["busy_s"] for o in outs)
    wall = max(o["window_s"] for o in outs)
    log(f"trace step {PROFILED_STEP} of the sharded session, all ranks: "
        f"wall {wall:.4f} s, device busy {busy:.4f} s (summed over the "
        f"{SHARDED_P} ranks' device events), card idle share at least "
        f"{1 - busy / wall:.4f}")
    return dict(launches=launches, scanned=r0["scanned"])


# ---------------------------------------------------------------------------
# phases 6-9: the serving path at llama3-8b width
# ---------------------------------------------------------------------------

PEAK_BF16_PER_S = 989e12    # dense bf16 tensor-core peak, H100 SXM
SERVE_SPEC = dict(slots=16, groups=4, max_seq=2048, prefill="packed",
                  prefill_capacity=2048, page_size=16, decode="replicated",
                  rebalance="tags", rebalance_every=8)
SERVE_TRACE = dict(seed=0, vocab=128256, prompt_buckets=(128, 256, 512, 1024),
                   max_new_cap=64)
# packed against full at full width, bf16: first-token logits within
# BF16_TOL of the largest |logit| (about five bf16 steps at that size:
# the two attention kernels sum in other orders and round once to bf16,
# and the difference passes through 32 layers); a step whose top-2
# logit margin is below that tolerance ends the token comparison
BF16_TOL = 0.02
# card against CPU at the smoke size, float32: 1e-4 of the largest |logit|
F32_TOL = 1e-4
SMOKE_SPEC = dict(slots=8, groups=4, max_seq=128, prefill="packed",
                  prefill_capacity=128, page_size=16, decode="replicated",
                  rebalance="tags", rebalance_every=4)
SMOKE_TRACE = dict(seed=1, vocab=512, prompt_buckets=(8, 16, 32),
                   max_new_cap=16)


class Recorder:
    """A session's ``on_logits`` observer: keeps each request's first-token
    logits, the top-2 logit margin of every token it is given, and the
    segment ids of every packed buffer.  It launches none of the port's
    kernels."""

    def __init__(self):
        self.first, self.margin, self.packs = {}, {}, []

    def __call__(self, reqs, logits, seg):
        if seg is not None:
            self.packs.append(seg.copy())
        top = logits.float().topk(2, dim=-1).values
        marg = (top[:, 0] - top[:, 1]).tolist()
        for i, r in enumerate(reqs):
            if r.rid not in self.first:
                self.first[r.rid] = logits[i].float().cpu()
                self.margin[r.rid] = []
            self.margin[r.rid].append(marg[i])


def serve_run(model, cfg, dev, spec_kw, trace, record=False, inspect=None):
    """One ``run_trace`` of a fresh session, the launch counts set to 0
    just before it and read just after; ``inspect(session)``, if given,
    then sees the session.  Returns (metrics, requests, launch counts,
    peak bytes, recorder)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeSession, ServeSpec, run_trace
    gc.collect()        # earlier sessions' caches must not count here
    rec = Recorder() if record else None
    session = ServeSession(model, cfg, ServeSpec(**spec_kw), device=dev,
                           on_logits=rec)
    reqs, submit = [], session.submit
    session.submit = lambda r: (reqs.append(r), submit(r))[1]
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    metrics = run_trace(session, trace)
    if dev != "cpu":
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    check(metrics["completed"] == len(trace), "not every request finished")
    check(all(len(r.out) == r.max_new for r in reqs), "output lengths")
    if inspect is not None:
        inspect(session)
    del session.submit  # the wrapper refers back to the session
    return metrics, reqs, counts, peak, rec


def log_serve(label, m, counts, peak):
    log(f"serve[{label}]: {m['requests']} requests, {m['steps']} steps, "
        f"{m['tokens']} tokens in {m['wall_s']:.4f} s: throughput_tok_s="
        f"{m['throughput_tok_s']:.2f} ttft_p50_s={m['ttft_p50_s']:.4f} "
        f"ttft_p99_s={m['ttft_p99_s']:.4f} itl_p50_s={m['itl_p50_s']:.4f} "
        f"itl_p99_s={m['itl_p99_s']:.4f} admission_tok_s="
        f"{m['admission_tok_s']:.2f} prefill_fill_frac="
        f"{m['prefill_fill_frac']:.4f} prefill_calls={m['prefill_calls']} "
        f"peak_mem_gb={peak / 1e9:.3f}")
    for e in m["migration_log"]:
        log(f"  rebalance at step {e['step']}: imbalance={e['imbalance']:.6f}"
            f" TotalV={e['TotalV']:.1f} retained={e['retained']:.4f}")
    log(f"  launches {counts}")


def serve_checked(model, cfg, dev, spec_kw, trace, label, **kw):
    """``serve_run`` with the balancer's histogram inputs recorded; logs
    the run and checks that the prefill's attention kernel ran on the
    tensor cores at every launch (the SSM family has no attention: none
    may run) and that the histogram kernel equals its plain version on
    every input the balancer handed it.  Returns what ``serve_run``
    returns."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.serve_prefill import packed_attention_cuda
    with recorded_hist_inputs() as hist_in:
        out = serve_run(model, cfg, dev, spec_kw, trace, **kw)
    m, _, counts, peak, _ = out
    log_serve(label, m, counts, peak)
    if cfg.family == "ssm":
        # the path's kernel is the balancer's histogram
        check(counts["flash_attention"] == counts["serve_prefill"] == 0
              and counts["ksection_hist"] > 0,
              f"{label}: the SSM path launched {counts}")
    else:
        name, wrapper = (("serve_prefill", packed_attention_cuda)
                         if spec_kw["prefill"] == "packed"
                         else ("flash_attention", flash_attention_cuda))
        variants = dict(wrapper.variants)
        log(f"  {name} launches by variant: {variants}")
        check(counts[name] > 0
              and variants["bf16_tensor_core"] == counts[name],
              f"{label}: {name} did not run on the tensor cores at every "
              f"launch ({counts[name]} launches, {variants})")
    check_hist_agreement(hist_agreement(hist_in), counts["ksection_hist"],
                         f"  the serving balancer ({label})")
    return out


def compare_recorded(label, reqs_a, rec_a, reqs_b, rec_b, rel_tol):
    """First-token logits within ``rel_tol`` of the largest |logit|;
    tokens equal up to the first one whose top-2 margin (in either run)
    is below that tolerance.  Returns the largest first-logit error."""
    worst, cut = 0.0, []
    for ra, rb in zip(reqs_a, reqs_b):
        check(ra.rid == rb.rid, f"{label}: request order")
        la, lb = rec_a.first[ra.rid], rec_b.first[rb.rid]
        tol = rel_tol * float(lb.abs().max())
        err = float((la - lb).abs().max())
        worst = max(worst, err / float(lb.abs().max()))
        check(err <= tol, f"{label}: request {ra.rid} first-token logits "
              f"differ by {err} > {tol}")
        ma, mb = rec_a.margin[ra.rid], rec_b.margin[rb.rid]
        check(len(ma) == len(ra.out) and len(mb) == len(rb.out),
              f"{label}: margins recorded")
        for t, (x, y) in enumerate(zip(ra.out, rb.out)):
            if min(ma[t], mb[t]) < tol:
                cut.append((ra.rid, t, len(ra.out)))
                break
            check(x == y, f"{label}: request {ra.rid} token {t}: {x} vs {y} "
                  f"with top-2 margins {ma[t]:.4g} / {mb[t]:.4g} >= {tol:.4g}")
    log(f"{label}: {len(reqs_a)} requests, first-token logits within "
        f"{worst:.3e} of max|logit| (tolerance {rel_tol}); tokens equal "
        f"except {len(cut)} requests cut short at a near-tie "
        f"(rid, token, of): {cut}")
    return worst


def serve_full_width(dev):
    """Phases 6-7: the llama3-8b-width session, packed (the main path),
    then packed and full recorded and held against each other."""
    from repro_torch.serve import bursty_trace
    cfg, model = full_width_model("llama3_8b", dev)
    trace = bursty_trace(32, **SERVE_TRACE)
    log(f"trace: {len(trace)} requests, prompts "
        f"{sorted({len(r.prompt) for r in trace})}, "
        f"{sum(len(r.prompt) for r in trace)} prompt tokens, "
        f"{sum(r.max_new for r in trace)} new tokens, arrivals to step "
        f"{trace[-1].arrival}")
    # warm-up: first calls load modules and create library handles
    warm = bursty_trace(3, **dict(SERVE_TRACE, seed=5, max_new_cap=4))
    for prefill in ("packed", "full"):
        serve_run(model, cfg, dev, dict(SERVE_SPEC, prefill=prefill), warm)
    out = {"cfg": cfg, "model": model, "trace": trace}
    m, reqs, counts, _, _ = serve_checked(model, cfg, dev, SERVE_SPEC, trace,
                                          "packed, the main path")
    out["packed"] = (m, counts)
    mp, rp, cp, pp, recp = serve_run(model, cfg, dev, SERVE_SPEC, trace,
                                     record=True)
    same = [a.out for a in reqs] == [b.out for b in rp]
    log(f"packed again, recorded: tokens equal to the first run: {same}")
    mf, rf, cf, pf, recf = serve_checked(model, cfg, dev,
                                         dict(SERVE_SPEC, prefill="full"),
                                         trace, "full", record=True)
    out["full"] = (mf, cf)
    out["fullest_pack"] = max(recp.packs, key=lambda sg: int((sg >= 0).sum()))
    out["recorded"] = (rp, recp)        # phase 13's tokens are held to it
    out["first_err"] = compare_recorded("packed vs full on the card", rp,
                                        recp, rf, recf, BF16_TOL)
    check(mp["migration_log"] == mf["migration_log"],
          "packed and full rebalance differently")
    return out


def serve_card_vs_cpu(dev, arch="llama3_8b", prefill="packed",
                      buckets=SMOKE_TRACE["prompt_buckets"]):
    """Phase 8 (and the SMOKE checks of phases 14-19): ``arch``'s SMOKE
    config in float32, the same port weights on both sides; the session
    (``prefill``, prompts snapped to ``buckets``) with the kernels on the
    card against the plain versions on the CPU."""
    import copy
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    from repro_torch.serve import bursty_trace
    cfg = get_smoke(arch).replace(use_pallas=True)
    cpu_model = init_model(cfg, seed=0, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    trace = bursty_trace(24, **dict(SMOKE_TRACE, vocab=cfg.vocab,
                                    prompt_buckets=buckets))
    spec = dict(SMOKE_SPEC, prefill=prefill)
    ma, ra, ca, _, reca = serve_run(card_model, cfg, dev, spec, trace,
                                    record=True)
    mb, rb, _, _, recb = serve_run(cpu_model, cfg, "cpu", spec, trace,
                                   record=True)
    kernel = ("serve_prefill" if prefill == "packed" else
              "ksection_hist" if cfg.family == "ssm" else "flash_attention")
    check(ca[kernel] > 0, f"smoke {arch}: {kernel} was not launched")
    compare_recorded(f"smoke {arch} {prefill} card vs CPU (float32)", ra,
                     reca, rb, recb, F32_TOL)
    check(ma["migration_log"] == mb["migration_log"],
          f"smoke {arch}: rebalances differ between card and CPU")
    lens = sorted({len(r.prompt) for r in trace})
    log(f"smoke {arch} {prefill}: prompts {lens} (window {cfg.window}), "
        f"{ma['steps']} steps, {ma['tokens']} tokens, "
        f"{len(ma['migration_log'])} rebalances equal, prefill calls "
        f"{ma['prefill_calls']} and {mb['prefill_calls']}, launches {ca}")


def bf16_step(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch
    mag = x.double().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def compare_mlp(serve, dev):
    """Phase 8b: the bf16 MLP at llama3-8b width (layer 0 of the serving
    model, 16 rows) on the card, where bf16 operands go straight into
    float32 products (torch.mm(..., out_dtype=float32)), against the same
    weights on the CPU, whose operands are upcast.  x.wg and x.wi agree
    within 1e-5 of their largest value (a product rounded to bf16 is
    ~2^-9 off); wo's product of the card's activation, rounded once, is
    within one bf16 step per element of the CPU's (or 2^-16 of the
    largest output, where cancellation leaves an element near 0 and
    float32 sums in another order differ by more than its step);
    mlp_apply on the card is exactly that composition.  The whole MLP
    against the CPU's is read, not held: an activation that rounds to
    the neighbouring bf16 value on one side moves the outputs of its row
    by more than a step where they are near 0."""
    import types
    import torch
    import torch.nn.functional as F
    from repro_torch.models.layers import matmul_f32, mlp_apply
    cfg, mlp = serve["cfg"], serve["model"].layers[0].mlp
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((16, cfg.d_model), generator=g, device=dev
                    ).to(torch.bfloat16)
    w = {n: getattr(mlp, n).detach().cpu() for n in ("wg", "wi", "wo")}
    xc = x.cpu()
    prods = {}
    for n in ("wg", "wi"):
        got, want = matmul_f32(x, getattr(mlp, n)), matmul_f32(xc, w[n])
        check(got.dtype == torch.float32, f"mlp: x.{n} is {got.dtype}")
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-5 * scale, f"mlp: x.{n} max err {err} > 1e-5 * "
              f"{scale}")
        prods[n] = (got, want, err, scale)
    h = (F.silu(prods["wg"][0]) * prods["wi"][0]).to(torch.bfloat16)
    h_cpu = (F.silu(prods["wg"][1]) * prods["wi"][1]).to(torch.bfloat16)
    got = matmul_f32(h, mlp.wo).to(torch.bfloat16).cpu()
    want = matmul_f32(h.cpu(), w["wo"]).to(torch.bfloat16)
    diff = (got.double() - want.double()).abs()
    floor = 2.0 ** -16 * float(want.double().abs().max())
    worst = float((diff / bf16_step(want).clamp_min(floor)).max())
    check(worst <= 1.0, f"mlp: wo's product {worst:.3f} of its limit off")
    full = mlp_apply(mlp, x, cfg).cpu()
    check(torch.equal(full, got), "mlp: mlp_apply on the card is not the "
          "composition of its checked products")
    full_cpu = mlp_apply(types.SimpleNamespace(**w), xc, cfg)
    beyond = int(((full.double() - full_cpu.double()).abs()
                  > bf16_step(full_cpu)).sum())
    flips = int((h.cpu() != h_cpu).sum())
    log(f"mlp d_model={cfg.d_model} d_ff={cfg.d_ff} bf16, 16 rows: x.wg "
        f"max err {prods['wg'][2]:.3e}, x.wi {prods['wi'][2]:.3e} (limits "
        f"1e-5 * max = {1e-5 * prods['wg'][3]:.3e}, "
        f"{1e-5 * prods['wi'][3]:.3e}); wo's product worst element at "
        f"{worst:.4f} of its limit (one bf16 step, floor {floor:.3e}); "
        f"whole MLP: {beyond} of {full.numel()} elements beyond one bf16 "
        f"step of the CPU's, {flips} of {h.numel()} activations rounded to "
        f"another bf16 value")


def attention_bound(pairs, hq, hkv, n_in, n_out, d, extra_bytes=0,
                    n_kv=None):
    """(bound ms, by): 4 d flops per visible (query, key) pair and head
    over the bf16 tensor-core peak, against the bytes the function must
    move over the memory rate: q (bf16) read once over the ``n_in``
    tokens that have a visible key, k and v over ``n_kv`` keys (default
    ``n_in``), o written once over all ``n_out`` rows."""
    n_kv = n_in if n_kv is None else n_kv
    t_ops = 4 * d * pairs / PEAK_BF16_PER_S * 1e3
    t_bytes = (2 * (hq * n_in + 2 * hkv * n_kv) * d + 2 * hq * n_out * d
               + extra_bytes) / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# bf16 attention: the kernel and the plain version both sum in float32 and
# round once to bf16, so an element may differ by one bf16 step (at most
# 2**-7 of its value), plus float32 rounding where the value is near 0
ATTN_RTOL, ATTN_ATOL = 2.0 ** -7, 1e-3


def attention_err(label, got, want):
    """Max abs error of ``got`` against ``want``, after checking every
    element within ATTN_RTOL * |want| + ATTN_ATOL; the reading also gives
    the worst element's error over its own limit."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    worst = float((diff / (ATTN_RTOL * w.abs() + ATTN_ATOL)).max())
    err = float(diff.max())
    check(worst <= 1.0, f"{label}: an element differs by {worst:.3f} times "
          f"its limit 2**-7 * |want| + 1e-3 (max abs err {err:.3e})")
    return err, (f"max_abs_err={err:.3e}, worst element at {worst:.4f} of "
                 "its limit 2**-7 * |want| + 1e-3")


def _bf16(shape, gen, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


# float32 attention: both sides sum in float32 in other orders (2e-5 of
# the largest output, as in tests/test_torch_cuda.py)
ATTN_F32_RTOL = 2e-5


def compare_flash(dev, s, dtype="bfloat16", hq=32, hkv=8, d=128,
                  window=None, b=1, s_kv=None, causal=True):
    """The flash kernel against mha_ref (by default b = 1, causal, 32 / 8
    heads, d = 128, no window; ``s_kv`` keys for ``s`` queries without a
    mask: cross-attention); SDPA (GQA; causal or no mask as the kernel;
    with a window, a boolean band mask) as the yardstick.  bf16 runs the
    tensor-core kernel, float32 the CUDA-core one (checked by the
    per-variant counts)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (VARIANTS,
                                                     flash_attention_cuda)
    s_kv = s if s_kv is None else s_kv
    # self-attention keeps the inputs of earlier runs' readings
    g = torch.Generator(device=dev).manual_seed(
        s if s_kv == s else 10007 * s + s_kv)
    dt = getattr(torch, dtype)
    q = torch.randn((b, hq, s, d), generator=g, device=dev).to(dt)
    k = torch.randn((b, hkv, s_kv, d), generator=g, device=dev).to(dt)
    v = torch.randn((b, hkv, s_kv, d), generator=g, device=dev).to(dt)
    variant = VARIANTS[dt]
    before = flash_attention_cuda.variants[variant]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    check(flash_attention_cuda.variants[variant] == before + 1,
          f"flash_attention {dtype}: the {variant} kernel did not run")
    want = ref.mha_ref(q, k, v, causal=causal, window=window)
    shape = (f"b={b} hq={hq} hkv={hkv} s={s} s_kv={s_kv} d={d} "
             f"{'causal' if causal else 'no mask'} window={window}")
    label = f"flash_attention {dtype} {shape}"
    if dt == torch.bfloat16:
        err, reading = attention_err(label, got, want)
    else:
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1.0)
        check(err <= ATTN_F32_RTOL * scale, f"{label}: max abs err {err} > "
              f"{ATTN_F32_RTOL} * {scale}")
        reading = f"max_abs_err={err:.3e} (limit {ATTN_F32_RTOL * scale:.3e})"
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
        pairs = s * (s + 1) // 2 if causal else s * s_kv
    else:
        i = torch.arange(s, device=dev)             # causal callers only
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
            q, k, v, attn_mask=band, enable_gqa=True)
        pairs = sum(min(r + 1, window) for r in range(s))
    lib_err = float((sdpa().float() - want.float()).abs().max())
    ms, call_ms = timed_ms(lambda: flash_attention_cuda(
        q, k, v, causal=causal, window=window))
    plain_ms, plain_call = timed_ms(
        lambda: ref.mha_ref(q, k, v, causal=causal, window=window), reps=5)
    lib_ms, lib_call = timed_ms(sdpa)
    bound, by = attention_bound(b * hq * pairs, hq, hkv, b * s, b * s, d,
                                n_kv=b * s_kv)
    log(f"flash_attention {shape} {dtype} ({variant}, {pairs} visible "
        f"pairs a head): kernel_ms={ms:.4f} (call {call_ms:.4f}) plain_ms="
        f"{plain_ms:.4f} (call {plain_call:.4f}) sdpa_ms={lib_ms:.4f} (call "
        f"{lib_call:.4f}) bound_ms={bound:.4f} ({by}, bf16 rates) "
        f"share={bound / ms:.4f} {reading} (sdpa max abs err {lib_err:.3e})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, max_abs_err=err)


def compare_packed(dev, seg_np, label="the path's fullest buffer", hq=32,
                   hkv=8, d=128, softcap=None):
    """The packed kernel against packed_attention_ref on one packed buffer
    (by default 32 / 8 heads, d = 128; bf16, optionally a soft cap):
    every element within one bf16 step, pad rows exactly 0, the same bits
    on a second call, on the tensor cores; SDPA with a boolean
    segment-causal mask as the yardstick, compared on real rows (SDPA has
    no soft cap: with one, it times the uncapped function and its error
    is not read)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.serve_prefill import packed_attention_cuda
    C = seg_np.shape[0]
    g = torch.Generator(device=dev).manual_seed(C)
    q = _bf16((hq, C, d), g, dev)
    k, v = _bf16((hkv, C, d), g, dev), _bf16((hkv, C, d), g, dev)
    seg = torch.as_tensor(seg_np, dtype=torch.int32, device=dev)
    before = packed_attention_cuda.variants["bf16_tensor_core"]
    got = packed_attention_cuda(q, k, v, seg, softcap=softcap)
    check(packed_attention_cuda.variants["bf16_tensor_core"] == before + 1,
          "serve_prefill bf16: the tensor-core kernel did not run")
    want = ref.packed_attention_ref(q, k, v, seg, softcap=softcap)
    err, reading = attention_err(f"serve_prefill ({label})", got, want)
    real = seg >= 0
    check(bool((got[:, ~real] == 0).all()), "serve_prefill: pad rows not 0")
    check(torch.equal(got, packed_attention_cuda(q, k, v, seg,
                                                 softcap=softcap)),
          "serve_prefill: two calls differ")
    i = torch.arange(C, device=dev)
    mask = (i[None, :] <= i[:, None]) & (seg[:, None] == seg[None, :]) \
        & real[:, None]
    qb, kb, vb = q[None], k[None], v[None]
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qb, kb, vb, attn_mask=mask, enable_gqa=True)
    lib_err = (float((sdpa()[0][:, real].float()
                      - want[:, real].float()).abs().max())
               if softcap is None else float("nan"))
    ms, call_ms = timed_ms(lambda: packed_attention_cuda(q, k, v, seg,
                                                         softcap=softcap))
    plain_ms, plain_call = timed_ms(
        lambda: ref.packed_attention_ref(q, k, v, seg, softcap=softcap),
        reps=5)
    lib_ms, lib_call = timed_ms(sdpa)
    _, lens = np.unique(seg_np[seg_np >= 0], return_counts=True)
    pairs = hq * int(sum(n * (n + 1) // 2 for n in lens.tolist()))
    n_real = int(real.sum())
    bound, by = attention_bound(pairs, hq, hkv, n_real, C, d,
                                extra_bytes=4 * C)
    log(f"serve_prefill ({label}) C={C} hq={hq} hkv={hkv} d={d} softcap="
        f"{softcap} bf16, "
        f"segments {lens.tolist()} ({n_real} real tokens, {pairs} visible "
        f"pairs over the heads): kernel_ms="
        f"{ms:.4f} (call {call_ms:.4f}) plain_ms={plain_ms:.4f} (call "
        f"{plain_call:.4f}) sdpa_ms={lib_ms:.4f} (call {lib_call:.4f}"
        f"{', without the cap' if softcap is not None else ''}) "
        f"bound_ms={bound:.4f} ({by}) share={bound / ms:.4f} {reading} "
        f"(sdpa max abs err on real rows {lib_err:.3e}); bit-identical "
        f"over two calls, pad rows 0")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms if softcap is None else None,
                max_abs_err=err)


# a full buffer whose requests span the buckets the trace never reaches
FULL_BUFFER = (1024, 512, 256, 128, 128)


def full_buffer_seg(C=2048, lengths=FULL_BUFFER):
    import numpy as np
    seg = np.full(C, -1, np.int32)
    off = 0
    for sid, n in enumerate(lengths):
        seg[off:off + n] = sid
        off += n
    return seg


def profile_serving(serve, dev):
    """Phase 9: one packed admission (the trace's first eight requests,
    one buffer) plus eight decode steps under torch.profiler."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeSession, ServeSpec

    def setup():
        gc.collect()
        session = ServeSession(serve["model"], serve["cfg"],
                               ServeSpec(**SERVE_SPEC), device=dev)
        for r in serve["trace"][:8]:
            session.submit(Request(rid=r.rid, prompt=r.prompt, max_new=64))
        return session

    def body(session):
        t0 = time.perf_counter()
        for _ in range(8):
            session.step()
        torch.cuda.synchronize()
        return session, time.perf_counter() - t0

    counts = {}

    def counted(session):
        counts["before"] = ops.launch_counts()
        out = body(session)
        counts["window"] = count_diff(ops.launch_counts(), counts["before"])
        return out

    prof, (session, wall) = profiled(counted, setup)
    check(session.prefill_stats["calls"] == 1, "one packed admission")
    trace_summary("one packed admission (8 x 128 tokens) + 8 decode steps",
                  prof, wall, top_host=10, top_dev=8,
                  launches=counts["window"])


# ---------------------------------------------------------------------------
# phase 13: sharded serving with KV migration (main path 4)
# ---------------------------------------------------------------------------

SHARDED_SERVE_SPEC = dict(SERVE_SPEC, decode="sharded", rebalance="kv")
# the forced migration: one request, full prefill (flash attention on the
# rank that holds its slot), moved to group 2 after FORCED_AT decode steps
FORCED_AT, FORCED_NEW, FORCED_GROUP = 3, 10, 2
# the profiled window holds one admission and decode steps only (its
# spec's rebalance_every is lifted: the first rebalance would fall at
# step 8 and migrate)
PROFILED_DECODE_STEPS = 8


class RankMargins:
    """A sharded session's ``on_logits`` observer on one rank: the top-2
    logit margin of each token this rank computed, by request and token
    index, and the first-token logits as numpy arrays (every rank
    computes each packed admission; a tensor would not outlive the rank's
    process).  It launches none of the port's kernels."""

    def __init__(self):
        self.first, self.margin = {}, {}

    def __call__(self, reqs, logits, seg):
        top = logits.float().topk(2, dim=-1).values
        marg = (top[:, 0] - top[:, 1]).tolist()
        for i, r in enumerate(reqs):
            t = len(r.out)          # the index of the token these logits give
            if t == 0 and r.rid not in self.first:
                self.first[r.rid] = logits[i].float().cpu().numpy()
            self.margin.setdefault(r.rid, {})[t] = marg[i]


def memory(dev):
    """(bytes allocated by this process, peak since the last reset, the
    card's free and total bytes); zeros on the CPU."""
    import torch
    if torch.device(dev).type != "cuda":
        return 0, 0, 0, 0
    free, total = torch.cuda.mem_get_info(dev)
    return (torch.cuda.memory_allocated(dev),
            torch.cuda.max_memory_allocated(dev), free, total)


def sharded_serve_rank(comm, cfg, weights, trace, spec_kw):
    """One rank of a sharded serving session (``spec_kw``; main path 4,
    and phase 18b's mamba2): group r's slots on this rank, the weights
    wrapped from ``weights`` (on the rank's card: shared with the parent,
    no copy; else copied there).  Runs a warm-up, then the trace with the
    launch counts from 0 (each migration timed, the balancer's histogram
    inputs recorded and held against the plain version afterwards), then
    a forced migration (under torch.profiler) against the same run
    without it, then the admission of 8 requests and 8 decode steps, no
    rebalance, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import model_from_tensors
    from repro_torch.serve import (Request, ServeSession, ServeSpec,
                                   bursty_trace, run_trace, slot_nbytes)
    dev = torch.device(comm.device)
    shared = all(t.device == dev for t in weights.values())
    model = model_from_tensors(cfg, weights if shared else
                               {k: t.to(dev) for k, t in weights.items()})
    out = {"layout": "shared" if shared else "copied",
           "mem_weights": memory(dev)[0]}

    def session(spec_kw, **kw):
        gc.collect()
        return ServeSession(model, cfg, ServeSpec(**spec_kw), comm=comm, **kw)

    def drive(sess, tr):
        reqs, submit = [], sess.submit
        sess.submit = lambda r: (reqs.append(r), submit(r))[1]
        m = run_trace(sess, tr)
        del sess.submit     # the wrapper refers back to the session
        return m, reqs

    # warm-up: first calls load modules and create library handles
    drive(session(spec_kw), bursty_trace(3, **dict(
        SERVE_TRACE, seed=5, max_new_cap=4, vocab=cfg.vocab)))

    packed = spec_kw["prefill"] == "packed"
    rec = RankMargins()
    sess = session(spec_kw, on_logits=rec)
    migrator, moves_timed = sess._migrator, []

    def timed_migrator(state, moves):
        sync(dev)
        wire0, staged0, t0 = (comm.all_to_all_bytes, comm.staged_bytes,
                              time.perf_counter())
        res = migrator(state, moves)
        sync(dev)
        moves_timed.append(dict(
            s=time.perf_counter() - t0, n=len(moves),
            wire=comm.all_to_all_bytes - wire0,
            staged=comm.staged_bytes - staged0, stats=res[1]))
        return res

    sess._migrator = timed_migrator
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    staged0 = comm.staged_bytes
    ops.reset_launch_counts()
    with recorded_hist_inputs() as hist_in:
        m, reqs = drive(sess, trace)
    sync(dev)
    out.update(launches=ops.launch_counts(), mem=memory(dev),
               staged=comm.staged_bytes - staged0, metrics=m,
               moves=moves_timed, kv_slot_bytes=sess.kv_slot_bytes,
               slot_bytes_now=slot_nbytes(sess.state, sess.axes),
               rids=[r.rid for r in reqs], out=[r.out for r in reqs],
               groups=[r.group for r in reqs],
               migrations=[r.migrations for r in reqs], margin=rec.margin,
               # a packed admission's first tokens are on every rank; a
               # full prefill's on the rank that holds the slot
               first=rec.first if comm.rank == 0 or not packed else None)
    del sess, rec
    out["hist"] = hist_agreement(hist_in)
    del hist_in

    forced_spec = dict(spec_kw, prefill="full", rebalance_every=1000)
    ops.reset_launch_counts()
    forced = {}
    for migrate in (False, True):
        sess = session(forced_spec)
        r = Request(rid=0, prompt=trace[0].prompt, max_new=FORCED_NEW)
        sess.submit(r)
        stats = None
        for i in range(FORCED_NEW + 4):
            sess.step()
            if migrate and i == FORCED_AT and not r.done:
                sync(dev)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    stats = sess.migrate_request(0, dst_group=FORCED_GROUP)
                    sync(dev)
                    wall = time.perf_counter() - t0
                out["forced_profile"] = dict(wall=wall, busy=sum(
                    e.time_range.elapsed_us()
                    for e in device_events(prof)) / 1e6)
            if r.done:
                break
        forced[migrate] = dict(out=list(r.out), group=r.group, done=r.done,
                               migrations=r.migrations, stats=stats)
        del sess
    out["forced"] = forced
    out["forced_launches"] = ops.launch_counts()

    sess = session(dict(spec_kw, rebalance_every=1000))
    for t in trace[:8]:
        sess.submit(Request(rid=t.rid, prompt=t.prompt, max_new=64))
    sync(dev)
    before = ops.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_DECODE_STEPS):
            sess.step()
        sync(dev)
        wall = time.perf_counter() - t0
    counts = count_diff(ops.launch_counts(), before)
    check(sess.prefill_stats["calls"] == (1 if packed else 8),
          "one packed admission, or eight full prefills")
    check(not sess.migration_log and counts["ksection_hist"] == 0,
          "the profiled window rebalanced")
    busy = sum(e.time_range.elapsed_us() for e in device_events(prof)) / 1e6
    if comm.rank == 0:
        admitted = ("one packed admission (8 x 128 tokens)" if packed
                    else "8 full prefills of 128 tokens")
        trace_summary(f"rank 0, {admitted} + {PROFILED_DECODE_STEPS} decode "
                      f"steps of the sharded session ({cfg.name}), no "
                      "rebalance", prof, wall, top_host=10, top_dev=8,
                      launches=counts)
    out["profile"] = dict(wall=wall, busy=busy)
    # weights that arrived by CUDA IPC go back to the parent's memory only
    # once every rank has dropped them before it exits (a rank that exits
    # holding them leaves them allocated in the parent for good)
    del sess, model
    weights.clear()
    gc.collect()
    return out


def sharded_serving(serve, spec_kw=SHARDED_SERVE_SPEC,
                    against="phase 6's replicated packed run"):
    """Phase 13: the sharded serving session with KV migration at
    llama3-8b width over SHARDED_P ranks (main path 4), checked rank
    against rank, against ``serve``'s recorded replicated run up to the
    first near-tie, and moved against unmoved (phase 18b: the same at
    mamba2 width, ``spec_kw`` with full prefill)."""
    import types
    import torch
    cfg, trace = serve["cfg"], serve["trace"]
    weights = {k: t.detach() for k, t in serve["model"].state_dict().items()}
    gc.collect()
    torch.cuda.empty_cache()
    parent_mem = memory("cuda")
    outs, backend = start_world(sharded_serve_rank, cfg, weights, trace,
                                spec_kw, join_s=900.0)
    r0 = outs[0]
    log(f"memory layout: weights {outs[0]['layout']} "
        f"({'one bf16 copy in this process, handed to the ranks by CUDA '
            'IPC' if r0['layout'] == 'shared' else 'a copy on each rank'})"
        f"; this process holds {parent_mem[0] / 1e9:.3f} GB ({cfg.name}'s "
        f"model and its float32 head); per rank after wrapping the weights "
        f"{[round(o['mem_weights'] / 1e9, 3) for o in outs]} GB, peak in "
        f"the trace (max_memory_allocated) "
        f"{[round(o['mem'][1] / 1e9, 3) for o in outs]} GB; card free / "
        f"total after the trace (mem_get_info, rank 0) "
        f"{r0['mem'][2] / 1e9:.3f} / {r0['mem'][3] / 1e9:.3f} GB")
    m = r0["metrics"]
    for r, o in enumerate(outs):
        om = o["metrics"]
        check(om["completed"] == len(trace), f"rank {r}: not every request "
              "finished")
        check(o["out"] == r0["out"] and o["groups"] == r0["groups"]
              and o["migrations"] == r0["migrations"],
              f"rank {r}: tokens or groups differ from rank 0's")
        check(om["migration_log"] == m["migration_log"],
              f"rank {r}: migration log differs from rank 0's")
        path_kernel = ("serve_prefill" if spec_kw["prefill"] == "packed"
                       else "ksection_hist" if cfg.family == "ssm"
                       else "flash_attention")
        check(o["launches"][path_kernel] > 0,
              f"rank {r}: {path_kernel} was not launched")
        check_hist_agreement(o["hist"], o["launches"]["ksection_hist"],
                             f"  rank {r}, the serving balancer")
    check(all(len(t) == q.max_new for t, q in zip(r0["out"], trace)),
          "output lengths")
    log_serve("sharded + kv, the main path, rank 0", m, r0["launches"],
              r0["mem"][1])
    log(f"  launches per rank {[o['launches'] for o in outs]}")
    kv = r0["kv_slot_bytes"]
    n_moved = sum(e["n_moved"] for e in m["migration_log"])
    moved = r0["moves"]
    check(len(moved) == sum(1 for e in m["migration_log"] if e["n_moved"]),
          "one executor call per rebalance that moved slots")
    for e in m["migration_log"]:
        # the log carries the executor's float32 sum of slot_nbytes (the
        # reference's weights), the host count n_moved x kv_slot_bytes is
        # exact: equal up to float32 rounding
        exact = e["n_moved"] * kv
        check(abs(e["moved_kv_bytes"] - exact) <= exact * 2.0 ** -22,
              f"rebalance at step {e['step']}: moved_kv_bytes "
              f"{e['moved_kv_bytes']} against {e['n_moved']} x {kv}")
        log(f"  rebalance at step {e['step']}: n_moved={e['n_moved']} "
            f"moved_kv_bytes={e['moved_kv_bytes']} (executor, float32; "
            f"n_moved x kv_slot_bytes = {exact}) deferred={e['deferred']} "
            f"deferred_retries={e['deferred_retries']}")
    check(n_moved >= 1, "no KV slot migrated in the trace")
    check(sum(r0["migrations"]) == n_moved, "migrations per request")
    logged = [e["moved_kv_bytes"] for e in m["migration_log"] if e["n_moved"]]
    for j, (mv, want) in enumerate(zip(moved, logged)):
        check(mv["stats"]["moved_bytes"] == want
              and mv["stats"]["received_bytes"] == want
              and mv["stats"]["n_moved"] == mv["n"]
              and mv["stats"]["overflow"] == 0,
              f"migration {j}: executor stats {mv['stats']}")
        log(f"  migration {j}: {mv['n']} slots, moved_kv_bytes "
            f"{mv['n'] * kv}, seconds per rank "
            f"{[round(o['moves'][j]['s'], 4) for o in outs]}, wire bytes "
            f"per rank {[o['moves'][j]['wire'] for o in outs]}, host-staged "
            f"bytes per rank {[o['moves'][j]['staged'] for o in outs]}")
    log(f"sharded serving ({backend}): kv_slot_bytes={kv} (a slot as the "
        f"session built it, the reference's count); a slot row holds "
        f"{r0['slot_bytes_now']} bytes after the trace (a recurrent family's "
        f"conv windows turn float32 at the first decode step), so the "
        f"exchange shipped "
        f"{n_moved * r0['slot_bytes_now']} bytes of slot rows; "
        f"{len(r0['moves'])} migrations moved {n_moved} slots "
        f"({n_moved * kv} bytes); host-staged bytes per rank in the trace "
        f"{[o['staged'] for o in outs]}")
    margins = {}
    for o in outs:
        for rid, by_t in o["margin"].items():
            margins.setdefault(rid, {}).update(by_t)
    first = {}
    for o in outs:
        first.update(o["first"] or {})
    rec = types.SimpleNamespace(first={
        rid: torch.from_numpy(a) for rid, a in first.items()}, margin={
        rid: [by_t[t] for t in sorted(by_t)] for rid, by_t in margins.items()})
    reqs = [types.SimpleNamespace(rid=rid, out=o)
            for rid, o in zip(r0["rids"], r0["out"])]
    rp, recp = serve["recorded"]
    compare_recorded(f"sharded + kv vs {against}", reqs, rec, rp, recp,
                     BF16_TOL)
    for r, o in enumerate(outs):
        f = o["forced"]
        check(f[True]["out"] == f[False]["out"] == r0["forced"][False]["out"]
              and f[False]["done"] and f[True]["done"],
              f"rank {r}: the forced migration changed the mover's tokens")
        check(f[True]["migrations"] == 1
              and f[True]["group"] == FORCED_GROUP
              and f[True]["stats"]["moved_kv_bytes"] == kv
              and f[True]["stats"]["n_moved"] == 1,
              f"rank {r}: forced migration {f[True]}")
        flash = o["forced_launches"]["flash_attention"]
        attn_layers = 0 if cfg.family == "ssm" else cfg.n_layers
        check(flash == (2 * attn_layers if r == 0 else 0),
              f"rank {r}: {flash} flash_attention launches in the forced "
              "pair (the request's slot is on rank 0 at admission)")
    log(f"forced migration to group {FORCED_GROUP} after {FORCED_AT} decode "
        f"steps: {FORCED_NEW} tokens equal to the unmoved run bit for bit "
        f"on every rank; flash_attention launches per rank "
        f"{[o['forced_launches']['flash_attention'] for o in outs]}; the "
        f"one-slot migration ({kv} bytes) under torch.profiler: wall, "
        f"device busy (s) per rank "
        f"{[(o['forced_profile']['wall'], o['forced_profile']['busy']) for o in outs]}")
    # the ranks' device events overlap on the one card (their host
    # copies run at once), so only a rank's own idle share is read
    log(f"trace of the admission of 8 requests + {PROFILED_DECODE_STEPS} "
        f"decode steps, no rebalance: rank 0's idle share "
        f"{1 - r0['profile']['busy'] / r0['profile']['wall']:.4f}; wall, "
        f"device busy (s) per rank "
        f"{[(o['profile']['wall'], o['profile']['busy']) for o in outs]}")
    return dict(launches=[o["launches"] for o in outs],
                kv_slot_bytes=kv, slot_bytes_now=r0["slot_bytes_now"],
                moves=[(mv["n"], [o["moves"][j]["s"] for o in outs])
                       for j, mv in enumerate(moved)])


# ---------------------------------------------------------------------------
# phases 14-17: the other dense configs and the MoE family at full width
# ---------------------------------------------------------------------------

# depth kept on one 80 GB card (published widths; every other field as
# published): the deepest that leaves >= 10 GB free with the float32 head,
# the KV cache of SERVE_SPEC and the packed prefill's activations
DEPTH = {"command_r_plus_104b": 14, "phi35_moe_42b": 24, "grok_1_314b": 6,
         "qwen2_vl_72b": 33}
# phase 14: sliding window 4096 over a ring of S = 4096 positions; every
# prompt passes the window, so every decode reads a wrapped ring
SWA_SPEC = dict(slots=8, groups=4, max_seq=8192, prefill="full",
                decode="replicated", rebalance="tags", rebalance_every=8)
SWA_REQUESTS, SWA_PROMPT, SWA_NEW = 8, (4608, 6144), (64, 128)
SWA_FLASH_S = 6144
# SMOKE's window is 32: prompts of 48-96 tokens wrap the ring (the
# reference's chunked attention needs lengths that split into equal
# attn_chunk chunks)
RING_BUCKETS = (48, 64, 96)
GROK_SOFTCAP = 30.0


def free_memory():
    """Drop the previous phase's tensors before the next model is built."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def full_width_model(arch, dev):
    """``arch``'s published config (depth cut to DEPTH where the card
    forces it) with random bf16 weights from seed 0 on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    free_memory()
    full = get_config(arch)
    cfg = full.replace(use_pallas=True,
                       n_layers=DEPTH.get(arch, full.n_layers))
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
        f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"hd={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab} experts="
        f"{cfg.n_experts} top_k={cfg.top_k} window={cfg.window} softcap="
        f"{cfg.attn_logit_softcap}: {n} parameters ({memory(dev)[0] / 1e9:.3f}"
        f" GB on the card), random from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s; card free "
        f"{memory(dev)[2] / 1e9:.3f} of {memory(dev)[3] / 1e9:.3f} GB")
    return cfg, model


def swa_trace(vocab, seed=14):
    """SWA_REQUESTS requests two steps apart, prompts of SWA_PROMPT tokens
    and SWA_NEW new tokens (uniform, seeded)."""
    import numpy as np
    from repro_torch.serve.trace import TraceRequest
    rng = np.random.default_rng(seed)
    out = []
    for i in range(SWA_REQUESTS):
        s = int(rng.integers(SWA_PROMPT[0], SWA_PROMPT[1] + 1))
        out.append(TraceRequest(
            rid=i, arrival=2 * i,
            prompt=rng.integers(0, vocab, s).astype(np.int32),
            max_new=int(rng.integers(SWA_NEW[0], SWA_NEW[1] + 1))))
    return out


def ring_holds_the_newest(cache, S):
    """Every row of the KV cache holds the newest min(pos, S) positions,
    each once; returns the rows that hold exactly S."""
    import torch
    sp, pos = cache.stored_pos.cpu(), cache.pos.cpu()
    full = 0
    for r in range(sp.shape[0]):
        p = int(pos[r])
        valid = sorted(int(x) for x in sp[r][sp[r] >= 0])
        check(valid == list(range(max(0, p - S), p)),
              f"ring row {r}: stored positions are not the newest "
              f"{min(p, S)} before {p}")
        check(torch.equal(sp[r][sp[r] >= 0] % S,
                          torch.nonzero(sp[r] >= 0)[:, 0].to(sp.dtype)),
              f"ring row {r}: a position is not at its slot pos % S")
        full += len(valid) == S
    return full


def serve_swa(dev):
    """Phase 14: h2o-danube3-4b at full width and depth, full prefill with
    the window binding (prompts of 4,608-6,144 tokens over a ring of
    4,096), then the flash kernel with the window against its plain
    version at the path's longest prompt."""
    import torch
    from repro_torch.models import layers
    from repro_torch.serve.decode import cache_len
    cfg, model = full_width_model("h2o_danube3_4b", dev)
    S = cache_len(cfg, SWA_SPEC["max_seq"])
    check(S == cfg.window < SWA_PROMPT[0],
          f"a ring of {S} positions that every prompt wraps")
    trace = swa_trace(cfg.vocab)
    log(f"trace: {len(trace)} requests, prompts "
        f"{[len(r.prompt) for r in trace]}, new tokens "
        f"{[r.max_new for r in trace]}, ring S={S}")
    rows = {}

    def inspect(session):
        rows["full"] = ring_holds_the_newest(session.state, S)

    keep = lambda q, k, v, **kw: (q.dtype, tuple(q.shape),    # noqa: E731
                                  kw.get("window"))
    with recorded_calls(layers, "flash_attention_op", keep) as flash_in:
        _, _, counts, _, _ = serve_checked(
            model, cfg, dev, SWA_SPEC, trace,
            f"{cfg.name}, full prefill, window {cfg.window}", inspect=inspect)
    log(f"  flash calls (dtype, q shape, window): {sorted(set(flash_in))}")
    check(counts["flash_attention"] == len(trace) * cfg.n_layers,
          "one flash launch a layer a prompt")
    check(len(flash_in) == counts["flash_attention"]
          and all(dt == torch.bfloat16 and w == cfg.window
                  and shape[2] > cfg.window for dt, shape, w in flash_in),
          "a flash launch without the window, or a prompt inside it")
    check(rows["full"] == SWA_SPEC["slots"],
          f"{rows['full']} of {SWA_SPEC['slots']} rows hold {S} positions")
    log(f"  ring: every row holds the newest min(pos, {S}) positions at "
        f"pos % {S}; {rows['full']} of {SWA_SPEC['slots']} rows hold "
        f"exactly {S}")
    del model
    free_memory()
    row = compare_flash(dev, SWA_FLASH_S, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                        d=cfg.hd, window=cfg.window)
    return dict(launches=counts, row=row)


def serve_dense_widths(dev):
    """Phase 15: h2o-danube-1.8b (d = 80) and command-r-plus (hq 96 / hkv
    8, vocab 256,000; depth cut) over SERVE_TRACE with the config's
    vocab, packed and full, held against each other as phase 7 does;
    both attention kernels against their plain versions at each model's
    heads."""
    from repro_torch.serve import bursty_trace
    out = {}
    for arch in ("h2o_danube_1_8b", "command_r_plus_104b"):
        cfg, model = full_width_model(arch, dev)
        trace = bursty_trace(32, **dict(SERVE_TRACE, vocab=cfg.vocab))
        mp, rp, cp, _, recp = serve_checked(model, cfg, dev, SERVE_SPEC,
                                            trace, f"{cfg.name}, packed",
                                            record=True)
        mf, rf, cf, _, recf = serve_checked(
            model, cfg, dev, dict(SERVE_SPEC, prefill="full"), trace,
            f"{cfg.name}, full", record=True)
        compare_recorded(f"{cfg.name}: packed vs full on the card", rp, recp,
                         rf, recf, BF16_TOL)
        check(mp["migration_log"] == mf["migration_log"],
              f"{cfg.name}: packed and full rebalance differently")
        fullest = max(recp.packs, key=lambda sg: int((sg >= 0).sum()))
        del model, recp, recf
        free_memory()
        heads = dict(hq=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.hd)
        rows = {"flash": compare_flash(dev, 1024, window=cfg.window,
                                       **heads),
                "packed": compare_packed(dev, fullest,
                                         f"{cfg.name}'s fullest buffer",
                                         **heads)}
        out[arch] = dict(launches={"packed": cp, "full": cf}, rows=rows)
    return out


def moe_routing(model, cfg, dev, trace):
    """One packed admission (the trace's first eight requests, one buffer)
    with the input of every MoE layer recorded; per layer, the experts'
    load imbalance (``dispatch_quality``: max / mean items an expert)
    and the drop rate (1 - mean keep) over every item of the buffer and
    over the real tokens' items (pad tokens are routed and take capacity,
    as in the reference).  Returns layer 0's recorded inputs: the packed
    buffer's (1, C, d) and the decode step's (slots, 1, d) after it."""
    import torch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer
    from repro_torch.serve import Request, ServeSession, ServeSpec
    free_memory()
    rec = Recorder()
    session = ServeSession(model, cfg, ServeSpec(**SERVE_SPEC), device=dev,
                           on_logits=rec)
    for r in trace[:8]:
        session.submit(Request(rid=r.rid, prompt=r.prompt, max_new=64))
    C = SERVE_SPEC["prefill_capacity"]
    first = model.layers[0].moe
    keep = lambda moe, x, cfg: (x.detach().clone()           # noqa: E731
                                if x.shape[:2] == (1, C) or moe is first
                                else None)
    with recorded_calls(transformer, "moe_apply", keep) as seen:
        session.step()
    torch.cuda.synchronize()
    hidden = [h for h in seen if h is not None and h.shape[:2] == (1, C)]
    decode0 = [h for h in seen if h is not None and h.shape[1] == 1]
    check(session.prefill_stats["calls"] == 1 and len(rec.packs) == 1
          and len(hidden) == cfg.n_layers and len(decode0) == 1,
          "one packed admission and one decode step, one MoE input a layer")
    real = torch.as_tensor(rec.packs[0] >= 0, device=dev)
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * C * k / e), 1)
    lines = []
    for li, (layer, h) in enumerate(zip(model.layers, hidden)):
        _, idx, aux = M._route(layer.moe, h, cfg)
        _, kept = M._dispatch_indices(idx.reshape(1, -1), e, cap)
        kept = kept.reshape(C, k)
        q_all = M.dispatch_quality(idx, e)
        q_real = M.dispatch_quality(idx[0][real], e)
        lines.append(
            f"  layer {li:2d}: imbalance {float(q_all.imbalance):.4f} "
            f"(real tokens {float(q_real.imbalance):.4f}), drop rate "
            f"{1 - float(kept.float().mean()):.4f} (real tokens "
            f"{1 - float(kept[real].float().mean()):.4f}), aux "
            f"{float(aux):.4f}, items per expert "
            f"{q_all.part_weights.int().tolist()}")
    log(f"{cfg.name} routing of one packed admission: {int(real.sum())} real "
        f"tokens of {C} ({C * k} items; capacity {cap} an expert)")
    for line in lines:
        log(line)
    del session
    return hidden[0], decode0[0]


def moe_time_split(moe, h, cfg, label):
    """Device and call ms of one MoE layer on a recorded input, whole
    (``moe_apply``) and by piece: the router (``_route``), Algorithm 1's
    dispatch indices, the scatter into the (E, groups, capacity, d)
    buffer, the expert products (three float32-accumulated batched
    products and the activation) and the gather back with the gates.
    Device ms leaves host dispatch out; call ms keeps it where dispatch
    outlasts the device work."""
    import torch
    from repro_torch.models import moe as M
    from repro_torch.models.layers import bmm_f32
    b, s, d = h.shape
    e, k, act = cfg.n_experts, cfg.top_k, cfg.act_dtype
    cap = max(int(cfg.capacity_factor * s * k / e), 1)
    gate, idx, _ = M._route(moe, h, cfg)
    flat_e = idx.reshape(b, s * k)
    slot, keep = M._dispatch_indices(flat_e, e, cap)
    slot = torch.clamp(slot, max=cap - 1).long()
    group = torch.arange(b, device=h.device)[:, None].expand(b, s * k)
    tok = torch.arange(s * k, device=h.device) // k

    def scatter():
        x_disp = torch.zeros((e, b, cap, d), dtype=act, device=h.device)
        x_disp.index_put_((flat_e, group, slot),
                          torch.where(keep[..., None], h[:, tok], 0.0),
                          accumulate=True)
        return x_disp

    xe = scatter().reshape(e, b * cap, d)

    def experts():
        hh = torch.nn.functional.silu(bmm_f32(xe, moe.wg)) * bmm_f32(xe,
                                                                    moe.wi)
        return bmm_f32(hh.to(act), moe.wo).to(act).reshape(e, b, cap, d)

    y_e = experts()

    def gather():
        g = torch.where(keep[..., None], y_e[flat_e, group, slot], 0.0)
        g = g * gate.reshape(b, s * k)[..., None]
        return g.reshape(b, s, k, d).sum(dim=2).to(act)

    pieces = {"moe_apply": lambda: M.moe_apply(moe, h, cfg),
              "route": lambda: M._route(moe, h, cfg),
              "dispatch": lambda: M._dispatch_indices(flat_e, e, cap),
              "scatter": scatter, "experts": experts, "gather": gather}
    check(torch.equal(gather(), M.moe_apply(moe, h, cfg)[0]),
          f"{label}: the pieces do not compose to moe_apply")
    times = {name: timed_ms(fn, reps=10) for name, fn in pieces.items()}
    parts = sum(t[0] for n, t in times.items() if n != "moe_apply")
    flops = 2 * 3 * e * b * cap * d * cfg.d_ff
    wbytes = 3 * moe.wi.numel() * moe.wi.element_size()
    log(f"MoE layer time split ({label}: x {tuple(h.shape)}, capacity "
        f"{cap}, {e} x {b * cap} expert rows): " + ", ".join(
            f"{n} {t[0]:.4f} ms (call {t[1]:.4f})" for n, t in times.items())
        + f"; pieces sum to {parts:.4f} ms of device time; the expert "
        f"products' {flops:.3e} FLOPs take "
        f"{flops / PEAK_BF16_PER_S * 1e3:.4f} ms at the bf16 peak, their "
        f"weights' {wbytes / 1e9:.3f} GB {wbytes / PEAK_BYTES_PER_S * 1e3:.4f}"
        f" ms at the memory rate")
    return times


def moe_layer_check(moe, h, cfg, dev):
    """Layer 0's MoE on a recorded packed hidden state (bf16, as served)
    against the same layer in float32 on the card from the same weights
    upcast: the router is float32 on both sides, so the experts, gates,
    slots and keep flags are equal; the output is within BF16_TOL of its
    largest |value| (the bf16 layer rounds h, g's activation and each
    expert's output once; a rounding that flips moves an output near 0 by
    more than its own step)."""
    import torch
    from repro_torch.models import moe as M
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    m32 = M.MoE(cfg32, dev)
    with torch.no_grad():
        for name in ("router", "wi", "wg", "wo"):
            getattr(m32, name).copy_(getattr(moe, name).float())
    h32 = h.float()
    g16, i16, _ = M._route(moe, h, cfg)
    g32, i32, _ = M._route(m32, h32, cfg32)
    check(torch.equal(i16, i32) and torch.equal(g16, g32),
          "one MoE layer: routing differs between bf16 and float32")
    s = h.shape[1]
    cap = max(int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts), 1)
    s16, k16 = M._dispatch_indices(i16.reshape(1, -1), cfg.n_experts, cap)
    s32, k32 = M._dispatch_indices(i32.reshape(1, -1), cfg.n_experts, cap)
    check(torch.equal(s16, s32) and torch.equal(k16, k32),
          "one MoE layer: slot or keep differs")
    out16, _ = M.moe_apply(moe, h, cfg)
    out32, _ = M.moe_apply(m32, h32, cfg32)
    torch.cuda.synchronize()
    err = float((out16.float() - out32).abs().max())
    scale = float(out32.abs().max())
    step = bf16_step(out32)
    beyond = int(((out16.double() - out32.double()).abs() > step).sum())
    check(out16.dtype == torch.bfloat16 and err <= BF16_TOL * scale,
          f"one MoE layer: bf16 off float32 by {err} > {BF16_TOL} * {scale}")
    log(f"one MoE layer (d={cfg.d_model}, {cfg.n_experts} experts of "
        f"d_ff={cfg.d_ff}, top {cfg.top_k}, {s} tokens, capacity {cap}): "
        f"slots and keep equal ({int(k16.sum())} of {k16.numel()} items "
        f"kept); bf16 against float32 max abs err {err:.4e} = "
        f"{err / scale:.3e} of max |out| {scale:.4e} (limit {BF16_TOL}); "
        f"{beyond} of {out16.numel()} elements beyond one bf16 step")
    del m32


def serve_phi(dev):
    """Phase 16: phi3.5-moe (16 experts, top 2) at full width, depth cut:
    SERVE_SPEC over SERVE_TRACE (vocab 32,064) packed (the slice's
    headline path), then full prefill (printed, not compared: expert
    capacity couples the requests of a packed buffer); the routing of one
    packed admission per layer; one MoE layer in bf16 against float32."""
    from repro_torch.serve import bursty_trace
    cfg, model = full_width_model("phi35_moe_42b", dev)
    trace = bursty_trace(32, **dict(SERVE_TRACE, vocab=cfg.vocab))
    _, _, counts, _, _ = serve_checked(model, cfg, dev, SERVE_SPEC, trace,
                                       f"{cfg.name}, packed (the MoE path)")
    _, _, cf, _, _ = serve_checked(model, cfg, dev,
                                   dict(SERVE_SPEC, prefill="full"), trace,
                                   f"{cfg.name}, full")
    h0, d0 = moe_routing(model, cfg, dev, trace)
    moe_layer_check(model.layers[0].moe, h0, cfg, dev)
    moe_time_split(model.layers[0].moe, h0, cfg, "packed buffer")
    moe_time_split(model.layers[0].moe, d0, cfg, "decode step")
    profile_serving({"model": model, "cfg": cfg, "trace": trace}, dev)
    del model, h0, d0
    free_memory()
    return dict(launches={"packed": counts, "full": cf})


def serve_grok(dev):
    """Phase 17: grok-1 (8 experts of d_ff 32,768, soft cap 30) at full
    width, depth cut: SERVE_SPEC packed over SERVE_TRACE (vocab 131,072),
    every packed launch with the cap; the packed kernel with the cap
    against its plain version on the session's fullest buffer."""
    from repro_torch.serve import bursty_trace
    from repro_torch.serve import decode
    cfg, model = full_width_model("grok_1_314b", dev)
    trace = bursty_trace(32, **dict(SERVE_TRACE, vocab=cfg.vocab))
    keep = lambda q, k, v, seg, **kw: kw.get("softcap")      # noqa: E731
    with recorded_calls(decode, "packed_attention_op", keep) as caps:
        _, _, counts, _, rec = serve_checked(model, cfg, dev, SERVE_SPEC,
                                             trace, f"{cfg.name}, packed",
                                             record=True)
    log(f"  serve_prefill soft caps: {sorted(set(caps))} over {len(caps)} "
        "calls")
    check(len(caps) == counts["serve_prefill"] and set(caps) == {GROK_SOFTCAP},
          f"{cfg.name}: a packed launch without the soft cap")
    fullest = max(rec.packs, key=lambda sg: int((sg >= 0).sum()))
    del model, rec
    free_memory()
    row = compare_packed(dev, fullest, f"{cfg.name}'s fullest buffer",
                         hq=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.hd,
                         softcap=GROK_SOFTCAP)
    return dict(launches={"packed": counts}, row=row)


# ---------------------------------------------------------------------------
# phases 18-19: the SSM (mamba2) and hybrid (recurrentgemma) families
# ---------------------------------------------------------------------------

# phase 18b: mamba2 with sharded decode and KV-slot migration, full prefill
MAMBA_SHARDED_SPEC = dict(SERVE_SPEC, prefill="full", decode="sharded",
                          rebalance="kv")
# phase 19's flash reading: recurrentgemma's local attention at the longest
# prompt of swa_trace (10 query heads over 1 kv head, d = 256, window 2048)
HYBRID_FLASH_S = 6144


def slot_bytes_of(session):
    """(the session's kv_slot_bytes: a slot as it was built, the
    reference's count; the bytes a slot row holds now)."""
    from repro_torch.serve import slot_nbytes
    return session.kv_slot_bytes, slot_nbytes(session.state, session.axes)


def serve_mamba2(dev):
    """Phase 18: mamba2-1.3b at full width and depth (48 layers): phase 6's
    trace with full prefill (recorded: phase 18b's tokens are held to it),
    then swa_trace's long prompts with max_seq 8192.  The path launches
    no attention kernel: its kernel is the balancer's histogram, held
    against its plain version on every input.  Returns phase 18b's
    inputs and the path's launches."""
    from repro_torch.serve import bursty_trace
    cfg, model = full_width_model("mamba2_1_3b", dev)
    trace = bursty_trace(32, **dict(SERVE_TRACE, vocab=cfg.vocab))
    spec = dict(SERVE_SPEC, prefill="full")
    serve_run(model, cfg, dev, spec, bursty_trace(3, **dict(
        SERVE_TRACE, seed=5, max_new_cap=4, vocab=cfg.vocab)))   # warm-up
    slots = {}

    def inspect(session):
        slots["bytes"] = slot_bytes_of(session)

    m, reqs, counts, peak, rec = serve_checked(
        model, cfg, dev, spec, trace, f"{cfg.name}, full prefill (the SSM "
        "path)", record=True, inspect=inspect)
    log(f"  slot bytes: {slots['bytes'][0]} as built (the reference's "
        f"kv_slot_bytes: float32 state, {cfg.act_dtype} conv windows, "
        f"position), {slots['bytes'][1]} after decode (float32 windows)")
    long_trace = swa_trace(cfg.vocab)
    log(f"long trace: prompts {[len(r.prompt) for r in long_trace]}, new "
        f"tokens {[r.max_new for r in long_trace]}, max_seq "
        f"{SWA_SPEC['max_seq']}")
    _, _, long_counts, _, _ = serve_checked(
        model, cfg, dev, SWA_SPEC, long_trace, f"{cfg.name}, full prefill "
        f"of {SWA_PROMPT[0]}-{SWA_PROMPT[1]} tokens", inspect=inspect)
    return dict(cfg=cfg, model=model, trace=trace, recorded=(reqs, rec),
                launches=counts, long_launches=long_counts,
                slot_bytes=slots["bytes"])


def serve_hybrid(dev):
    """Phase 19: recurrentgemma-2b at full width and depth (26 layers: 18
    RG-LRU, 8 local attention): swa_trace over a ring of 2,048 positions
    (every prefill passes the window, every decode reads a wrapped ring;
    each attention layer's ring checked), then phase 6's trace with full
    prefill; every flash launch on the tensor cores with the window; then
    the flash kernel at d = 256 against its plain version at the longest
    prompt."""
    import torch
    from repro_torch.models import layers
    from repro_torch.serve import KVCache, bursty_trace
    from repro_torch.serve.decode import cache_len
    cfg, model = full_width_model("recurrentgemma_2b", dev)
    S = cache_len(cfg, SWA_SPEC["max_seq"])
    check(S == cfg.window < SWA_PROMPT[0],
          f"a ring of {S} positions that every prompt wraps")
    n_attn = sum(1 for block in model.layers if hasattr(block, "attn"))
    trace = swa_trace(cfg.vocab)
    log(f"trace: {len(trace)} requests, prompts "
        f"{[len(r.prompt) for r in trace]}, new tokens "
        f"{[r.max_new for r in trace]}, ring S={S} in each of {n_attn} "
        "attention layers")
    rows, slots = {}, {}

    def inspect(session):
        rings = [c for c in session.state.layers if isinstance(c, KVCache)]
        check(len(rings) == n_attn, "one ring an attention layer")
        rows["full"] = [ring_holds_the_newest(c, S) for c in rings]
        slots["bytes"] = slot_bytes_of(session)

    keep = lambda q, k, v, **kw: (q.dtype, tuple(q.shape),    # noqa: E731
                                  kw.get("window"))
    with recorded_calls(layers, "flash_attention_op", keep) as flash_in:
        _, _, counts, _, _ = serve_checked(
            model, cfg, dev, SWA_SPEC, trace,
            f"{cfg.name}, full prefill, window {cfg.window}", inspect=inspect)
    log(f"  flash calls (dtype, q shape, window): {sorted(set(flash_in))}")
    check(counts["flash_attention"] == len(trace) * n_attn,
          "one flash launch an attention layer a prompt")
    check(len(flash_in) == counts["flash_attention"]
          and all(dt == torch.bfloat16 and w == cfg.window
                  and shape[1] == cfg.n_heads and shape[3] == cfg.hd == 256
                  and shape[2] > cfg.window for dt, shape, w in flash_in),
          "a flash launch without the window, at another head dim, or a "
          "prompt inside the window")
    check(rows["full"] == [SWA_SPEC["slots"]] * n_attn,
          f"rows holding {S} positions per ring: {rows['full']}")
    log(f"  rings: every row of each of the {n_attn} rings holds the "
        f"newest min(pos, {S}) positions at pos % {S}; rows holding "
        f"exactly {S}: {rows['full']}; slot bytes {slots['bytes'][0]} as "
        f"built, {slots['bytes'][1]} after decode")
    short = bursty_trace(32, **dict(SERVE_TRACE, vocab=cfg.vocab))
    _, _, short_counts, _, _ = serve_checked(
        model, cfg, dev, dict(SERVE_SPEC, prefill="full"), short,
        f"{cfg.name}, phase 6's trace, full prefill")
    del model
    free_memory()
    row = compare_flash(dev, HYBRID_FLASH_S, hq=cfg.n_heads,
                        hkv=cfg.n_kv_heads, d=cfg.hd, window=cfg.window)
    return dict(launches=counts, short_launches=short_counts, row=row)


# ---------------------------------------------------------------------------
# phases 20-21: the encoder-decoder (whisper) and the M-RoPE VLM (qwen2-vl)
# ---------------------------------------------------------------------------

# phase 20a: whisper's batch API: 16 rows of 1,500 stub frames (seeded
# random embeddings) and 128-token prompts, then 64 greedy decode steps
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_STEPS = 16, 128, 64
# phase 21b: the VLM front end: 4 rows of 256 patch embeddings before
# 128-token prompts, then 8 decode steps
VLM_ROWS, VLM_PROMPT, VLM_STEPS = 4, 128, 8


def flash_call(q, k, v, causal=True, window=None, **kw):
    """What ``recorded_calls`` keeps of a flash call: (dtype, q shape, k
    shape, causal, window)."""
    return q.dtype, tuple(q.shape), tuple(k.shape), causal, window


def batch_run(model, cfg, dev, batch, max_seq, steps):
    """``prefill(batch)`` then ``steps`` greedy decode steps on the card,
    the launch counts set to 0 just before and the flash calls recorded.
    Returns the prefill's float32 logits, each step's tokens and top-2
    margins, the seconds of the prefill and of each step, the counts
    after the prefill and after the run, the flash calls, and the
    cross-attention K/V bytes of one row (encoder-decoder)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.serve.decode import decode_step, prefill
    gc.collect()
    torch.cuda.synchronize()
    out = dict(tokens=[], margins=[], step_s=[])
    ops.reset_launch_counts()
    with recorded_calls(layers, "flash_attention_op", flash_call) as calls:
        t0 = time.perf_counter()
        logits, state = prefill(model, batch, cfg, max_seq=max_seq)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_counts"] = ops.launch_counts()
        out["prefill_calls"] = len(calls)
        out["first"] = logits.float().cpu()
        for _ in range(steps + 1):
            top = logits.float().topk(2, dim=-1)
            out["margins"].append((top.values[:, 0]
                                   - top.values[:, 1]).cpu())
            tok = top.indices[:, :1]
            out["tokens"].append(tok[:, 0].cpu())
            if len(out["tokens"]) > steps:
                break
            t0 = time.perf_counter()
            logits, state = decode_step(model, state, tok, cfg)
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            logits = logits[:, -1]
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    out["counts"] = ops.launch_counts()
    out["variants"] = dict(flash_attention_cuda.variants)
    out["calls"] = list(calls)
    if hasattr(state, "cross_k"):
        out["cross_row_bytes"] = 2 * (state.cross_k[:, 0].numel()
                                      * state.cross_k.element_size())
    del state
    return out


def batch_against_plain(model, cfg, dev, batch, max_seq, steps, label):
    """``batch_run`` with the kernels (``use_pallas=True``) and on the
    plain route (``use_pallas=False``: no kernel launches) on the same
    card and weights: the prefill's logits within BF16_TOL of the largest
    |logit|; each row's tokens equal up to its first near-tie (a top-2
    margin below that tolerance in either run).  Returns the kernel
    run."""
    import torch
    runs = {use: batch_run(model, cfg.replace(use_pallas=use), dev, batch,
                           max_seq, steps) for use in (True, False)}
    k, p = runs[True], runs[False]
    check(p["counts"]["flash_attention"] == 0,
          f"{label}: the plain route launched {p['counts']}")
    scale = float(p["first"].abs().max())
    err = float((k["first"] - p["first"]).abs().max())
    tol = BF16_TOL * scale
    check(err <= tol, f"{label}: prefill logits differ by {err} > {tol}")
    cut = []
    for row in range(k["first"].shape[0]):
        for t in range(steps + 1):
            if min(float(k["margins"][t][row]),
                   float(p["margins"][t][row])) < tol:
                cut.append((row, t))
                break
            check(int(k["tokens"][t][row]) == int(p["tokens"][t][row]),
                  f"{label}: row {row} token {t} differs above a near-tie")
    step = sorted(k["step_s"])
    log(f"{label}: prefill {k['prefill_s']:.4f} s (plain route "
        f"{p['prefill_s']:.4f}), decode step p50 {step[len(step) // 2]:.4f} "
        f"s max {step[-1]:.4f} (plain p50 "
        f"{sorted(p['step_s'])[len(step) // 2]:.4f}); prefill logits within "
        f"{err / scale:.3e} of max|logit| (tolerance {BF16_TOL}); tokens "
        f"equal except {len(cut)} rows cut short at a near-tie (row, "
        f"token): {cut}")
    return k


def check_flash_bf16(label, run, expected):
    """Every flash launch of a ``batch_run`` ran the bf16 tensor-core
    kernel, and there were ``expected`` of them."""
    counts, variants = run["counts"], run["variants"]
    check(counts["flash_attention"] == expected
          and variants["bf16_tensor_core"] == expected,
          f"{label}: {counts['flash_attention']} flash launches, expected "
          f"{expected}, all bf16 on the tensor cores ({variants})")


def serve_whisper(dev):
    """Phase 20: whisper-medium at full width and depth (24 + 24 layers).
    (a) The batch API: prefill of 16 rows of 1,500 frames and 128-token
    prompts, 64 decode steps, every flash launch checked (encoder
    non-causal at 1,500, decoder causal, cross-attention at prefill and
    decode), held against the plain route; (b) a 'cheap' ServeSession
    over phase 6's trace (zero cross K/V, the reference's engine path);
    (d) the kernel at the encoder's and the cross-attention's shapes."""
    import torch
    from repro_torch.models import layers
    from repro_torch.serve import bursty_trace
    cfg, model = full_width_model("whisper_medium", dev)
    L, h, hd, F = cfg.n_layers, cfg.n_heads, cfg.hd, cfg.enc_seq
    g = torch.Generator(device=dev).manual_seed(20)
    frames = torch.randn((WHISPER_ROWS, F, cfg.d_model), generator=g,
                         device=dev).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (WHISPER_ROWS, WHISPER_PROMPT),
                           generator=g, device=dev)
    warm = {"frames": frames[:1], "tokens": tokens[:1, :16]}
    batch_run(model, cfg, dev, warm, 64, 2)
    k = batch_against_plain(model, cfg, dev,
                            {"frames": frames, "tokens": tokens}, 2048,
                            WHISPER_STEPS, f"{cfg.name} batch API, "
                            f"{WHISPER_ROWS} rows x {F} frames + "
                            f"{WHISPER_PROMPT} tokens, {WHISPER_STEPS} steps")
    check(k["prefill_counts"]["flash_attention"] == k["prefill_calls"]
          == cfg.enc_layers + 2 * L,
          f"prefill: {k['prefill_counts']['flash_attention']} flash "
          f"launches, expected {cfg.enc_layers + 2 * L}")
    check_flash_bf16("whisper batch API", k,
                     cfg.enc_layers + 2 * L + WHISPER_STEPS * L)
    b, s = WHISPER_ROWS, WHISPER_PROMPT
    want = sorted([(torch.bfloat16, (b, h, F, hd), (b, h, F, hd), False,
                    None)] * cfg.enc_layers
                  + [(torch.bfloat16, (b, h, s, hd), (b, h, s, hd), True,
                      None)] * L
                  + [(torch.bfloat16, (b, h, s, hd), (b, h, F, hd), False,
                      None)] * L
                  + [(torch.bfloat16, (b, h, 1, hd), (b, h, F, hd), False,
                      None)] * (WHISPER_STEPS * L), key=str)
    check(sorted(k["calls"], key=str) == want,
          "whisper's flash calls are not the encoder's, the decoder's and "
          "the cross-attention's shapes")
    log(f"  flash launches: {k['prefill_counts']['flash_attention']} at "
        f"prefill ({cfg.enc_layers} encoder at {F} x {F} no mask, {L} "
        f"decoder causal at {s}, {L} cross at {s} x {F}), "
        f"{(k['counts']['flash_attention'] - k['prefill_calls']) // WHISPER_STEPS}"
        f" a decode step (1 x {F}); all bf16 on the tensor cores")
    log(f"  cross K/V bytes a row: {k['cross_row_bytes']} ({L} layers x {h} "
        f"heads x {F} frames x {hd} x 2 (K, V) x 2 B)")
    check(k["cross_row_bytes"] == L * h * F * hd * 2 * 2, "cross K/V bytes")
    del frames, tokens
    free_memory()
    trace = bursty_trace(32, **dict(SERVE_TRACE, vocab=cfg.vocab))
    spec = dict(SERVE_SPEC, prefill="cheap")
    serve_run(model, cfg, dev, spec, bursty_trace(3, **dict(
        SERVE_TRACE, seed=5, max_new_cap=4, vocab=cfg.vocab)))   # warm-up
    slots = {}

    def inspect(session):
        slots["bytes"] = slot_bytes_of(session)
        slots["cross_zero"] = bool((session.state.cross_k == 0).all()
                                   and (session.state.cross_v == 0).all())
        slots["max_pos"] = int(session.state.pos.max())

    with recorded_calls(layers, "flash_attention_op", flash_call) as calls:
        m, reqs, counts, peak, _ = serve_checked(
            model, cfg, dev, spec, trace, f"{cfg.name}, cheap prefill (the "
            "reference's engine path)", inspect=inspect)
    check(len(calls) == counts["flash_attention"] > 0
          and all(c[1][2] == 1 and c[2][2] == F and not c[3]
                  for c in calls),
          "the cheap session's flash calls are not 1 x 1500 cross calls")
    check(slots["cross_zero"], "the cheap session's cross K/V are not zero")
    log(f"  cheap session: {counts['flash_attention']} cross-attention "
        f"launches ({len(calls) // L} decode steps x {L}); slot bytes "
        f"{slots['bytes'][0]}; cross K/V zero as in the reference; row "
        f"positions reach {slots['max_pos']} (the sinusoid index clamps "
        f"past {spec['max_seq']})")
    del model
    free_memory()
    rows = {"encoder": compare_flash(dev, F, hq=h, hkv=h, d=hd, b=b,
                                     causal=False),
            "cross_prefill": compare_flash(dev, s, hq=h, hkv=h, d=hd, b=b,
                                           s_kv=F, causal=False),
            "cross_decode": compare_flash(dev, 1, hq=h, hkv=h, d=hd, b=b,
                                          s_kv=F, causal=False)}
    return dict(batch_launches=k["counts"], launches=counts, rows=rows)


def encdec_card_vs_cpu(dev):
    """Phase 20c: whisper SMOKE's batch API in float32, the same weights on
    the card (kernels) and the CPU (plain versions): prefill and 4 decode
    steps, logits within F32_TOL of the largest."""
    import copy
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models import init_model
    from repro_torch.serve.decode import decode_step, prefill
    cfg = get_smoke("whisper_medium").replace(use_pallas=True)
    cpu = init_model(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(21)
    frames = torch.randn((3, cfg.enc_seq, cfg.d_model), generator=g)
    tokens = torch.randint(0, cfg.vocab, (3, 9), generator=g)

    def run(model, on):
        """Prefill and 4 decode steps on ``on``, fed the CPU run's tokens
        (``fed``, filled by the CPU run, which goes first)."""
        out = []
        logits, state = prefill(model, {"frames": frames.to(on),
                                        "tokens": tokens.to(on)}, cfg,
                                max_seq=32)
        for step in range(5):
            out.append(logits.reshape(3, -1).cpu())
            if step == 4:
                return out
            if on == "cpu":
                fed.append(torch.argmax(out[-1], dim=-1)[:, None])
            logits, state = decode_step(model, state, fed[step].to(on), cfg)

    fed = []
    want = run(cpu, "cpu")
    ops.reset_launch_counts()
    got = run(card, dev)
    counts = ops.launch_counts()
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, want))
    check(worst <= F32_TOL, f"smoke whisper batch API: {worst} of "
          "max|logit|")
    check(counts["flash_attention"] == cfg.enc_layers + 6 * cfg.n_layers,
          f"smoke whisper batch API: {counts['flash_attention']} flash "
          "launches")
    log(f"smoke whisper batch API (float32) card vs CPU: prefill and 4 "
        f"decode steps within {worst:.3e} of max|logit| (tolerance "
        f"{F32_TOL}); {counts['flash_attention']} flash launches")


def serve_qwen2_vl(dev):
    """Phase 21: qwen2-vl-72b at full width (depth cut by DEPTH): (a) a
    'full' ServeSession over phase 6's trace, every flash launch bf16 on
    the tensor cores at 64 / 8 heads, and 'packed' refused with the
    reference's "mrope" message; (b) the VLM front end through the batch
    API: 4 rows of 256 patch embeddings and 128-token prompts, 8 decode
    steps, held against the plain route."""
    import torch
    from repro_torch.models import layers
    from repro_torch.serve import ServeSession, ServeSpec, bursty_trace
    cfg, model = full_width_model("qwen2_vl_72b", dev)
    try:
        ServeSession(model, cfg, ServeSpec(**SERVE_SPEC), device=dev)
        check(False, "packed prefill was not refused for M-RoPE")
    except ValueError as e:
        check("mrope" in str(e), f"packed refused for another reason: {e}")
        log(f"  packed prefill refused: {e}")
    free_memory()
    trace = bursty_trace(32, **dict(SERVE_TRACE, vocab=cfg.vocab))
    spec = dict(SERVE_SPEC, prefill="full")
    serve_run(model, cfg, dev, spec, bursty_trace(3, **dict(
        SERVE_TRACE, seed=5, max_new_cap=4, vocab=cfg.vocab)))   # warm-up
    with recorded_calls(layers, "flash_attention_op", flash_call) as calls:
        _, _, counts, _, _ = serve_checked(
            model, cfg, dev, spec, trace, f"{cfg.name} ({cfg.n_layers} "
            "layers), full prefill")
    check(counts["flash_attention"] == len(trace) * cfg.n_layers
          == len(calls), "one flash launch a layer a prompt")
    check(all(c[0] == torch.bfloat16 and c[1][1] == cfg.n_heads
              and c[2][1] == cfg.n_kv_heads and c[1][3] == cfg.hd and c[3]
              for c in calls),
          "a flash launch not bf16 causal at 64 / 8 heads, d = 128")
    # the kernel at the session's shapes: one row per prompt length, with
    # the session's launches at that length
    free_memory()
    lengths = {}
    for c in calls:
        lengths[c[1][2]] = lengths.get(c[1][2], 0) + 1
    flash_rows = {s: dict(compare_flash(dev, s, hq=cfg.n_heads,
                                        hkv=cfg.n_kv_heads, d=cfg.hd),
                          launches=n) for s, n in sorted(lengths.items())}
    log(f"  flash launches by prompt length: {dict(sorted(lengths.items()))}")
    g = torch.Generator(device=dev).manual_seed(21)
    patches = torch.randn((VLM_ROWS, cfg.vision_patches, cfg.d_model),
                          generator=g, device=dev).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (VLM_ROWS, VLM_PROMPT), generator=g,
                           device=dev)
    k = batch_against_plain(model, cfg, dev, {"tokens": tokens,
                                              "patch_embeds": patches},
                            SERVE_SPEC["max_seq"], VLM_STEPS,
                            f"{cfg.name} batch API, {VLM_ROWS} rows x "
                            f"{cfg.vision_patches} patches + {VLM_PROMPT} "
                            f"tokens, {VLM_STEPS} steps")
    n_in = cfg.vision_patches + VLM_PROMPT
    check_flash_bf16("qwen2-vl batch API", k, cfg.n_layers)
    check(all(c[1][2] == n_in for c in k["calls"]),
          f"the VLM prefill's flash calls are not at {n_in} positions")
    del model
    return dict(launches=counts, batch_launches=k["counts"],
                flash_rows=flash_rows)


# ---------------------------------------------------------------------------
# phase 22: training at llama3-8b width (main path 5: launch.train.train)
# ---------------------------------------------------------------------------

# depth kept for training on one 80 GB card (published widths; remat on,
# bf16, the plain attention as in the reference): the deepest that leaves
# >= 10 GB free with bf16 parameters and gradients, float32 AdamW moments,
# the update's float32 temporaries (slices of optimizer.UPDATE_CHUNK), the
# remat-saved layer inputs, one layer's recompute and the loss's logits
TRAIN_DEPTH = 20
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STREAM, TRAIN_REPEAT = 5, 5    # steps on the stream, then one batch
TRAIN_LR = 1e-4
# phase 22b: the reference's packing test shape
PACK_LENGTHS, PACK_ROWS, PACK_SEEDS = 256, 16, 4
# phase 22c: SMOKE, float32, card against CPU from the same weights
SMOKE_TRAIN_STEPS, SMOKE_TRAIN_LR = 3, 1e-3
SMOKE_LOSS_RTOL = 1e-4


def train_flops(cfg, tokens):
    """(model FLOPs of one training step, the plain attention's FLOPs, the
    matmul parameters N): 6 N tokens for the products of the layers and
    the LM head (forward and backward), plus 2 N_layers tokens for the
    remat's second forward of the layers; the attention's QK and PV
    products over the full s x s square the chunked route computes (2
    FLOPs a multiply-add), forward, backward and recomputed."""
    hd, d = cfg.hd, cfg.d_model
    per_layer = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    n_layers = cfg.n_layers * per_layer
    n_matmul = n_layers + d * cfg.vocab
    model = 6 * n_matmul * tokens + (2 * n_layers * tokens if cfg.remat
                                     else 0)
    attn = 4 * 4 * cfg.n_heads * hd * tokens * TRAIN_SEQ * cfg.n_layers
    return model, attn, n_matmul


def train_full_width(dev):
    """Phase 22a: llama3-8b at full width, TRAIN_DEPTH layers, bf16, remat
    on, through ``launch.train.train``: TRAIN_STREAM steps on the
    synthetic corpus packed on the card (every packed batch launches
    ``prefix_scan``), each loss finite and below 2 ln(vocab) (the
    reference's smoke bound), then TRAIN_REPEAT steps on one repeated
    batch, whose last loss must be below its first.  Prints each step's
    split (packing, forward + backward, update), tokens/s, the peak
    memory and the model-FLOPs share.  Then holds layer 0's and the
    head's bf16 gradients through ``_ProductF32`` against the emulated
    and plain routes (``layer_product_grads``)."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import corpus_stream, train
    free_memory()
    full = get_config("llama3_8b")
    cfg = full.replace(n_layers=TRAIN_DEPTH)
    check(cfg.remat and not cfg.use_pallas and cfg.dtype == "bfloat16",
          "the training config is not bf16 with remat and plain attention")
    stream = corpus_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    repeated = []

    def batches():
        for _ in range(TRAIN_STREAM):
            yield next(stream)
        repeated.append(next(stream))
        for _ in range(TRAIN_REPEAT):
            yield repeated[0]

    steps = TRAIN_STREAM + TRAIN_REPEAT
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_calls(ops, "exclusive_scan_op",
                        lambda x, **kw: x.detach().clone()) as scans:
        out = train(cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    lr=TRAIN_LR, ckpt=None, device=dev, batches=batches(),
                    log=log)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_scan_agreement(scans, counts["prefix_scan"], "phase 22a")
    peak = memory(dev)[1]
    n_params = sum(p.numel() for p in out["model"].parameters())
    hist = out["history"]
    profile_train_step(cfg, out["model"], out["opt"], repeated[0], dev)
    out["opt"] = None
    free_memory()
    row = {k: torch.as_tensor(v[:1], device=dev)
           for k, v in repeated[0].items()}
    layer_product_grads(out["model"], row["tokens"], row["labels"], cfg)
    del out, row
    free_memory()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for r in hist:
        t = r["t_pack"] + r["t_grad"] + r["t_update"]
        log(f"  train step {r['step']}: loss {r['loss']:.6f} gnorm "
            f"{r['gnorm']:.4f} lr {r['lr']:.3e}; {t:.4f} s = pack "
            f"{r['t_pack']:.4f} + forward/backward {r['t_grad']:.4f} + "
            f"update {r['t_update']:.4f}")
    losses = [r["loss"] for r in hist]
    cap = 2 * math.log(cfg.vocab)
    check(all(math.isfinite(x) and x < cap for x in losses[:TRAIN_STREAM]),
          f"a stream step's loss is not finite or not below 2 ln(vocab) = "
          f"{cap:.4f}: {losses[:TRAIN_STREAM]}")
    rep = losses[TRAIN_STREAM:]
    check(rep[-1] < rep[0], f"the repeated batch's loss did not fall: {rep}")
    check(counts["prefix_scan"] >= TRAIN_STREAM + 1,
          f"prefix_scan launched {counts['prefix_scan']} times for "
          f"{TRAIN_STREAM + 1} packed batches")
    check(counts["flash_attention"] == 0 and counts["serve_prefill"] == 0,
          f"an attention kernel ran on the training path: {counts}")
    steady = hist[1:]
    med = lambda k: statistics.median(r[k] for r in steady)  # noqa: E731
    packed = hist[1:TRAIN_STREAM + 1]      # steps that packed a batch
    t_step = statistics.median(r["t_pack"] + r["t_grad"] + r["t_update"]
                               for r in packed)
    pack = statistics.median(r["t_pack"] for r in packed)
    flops, attn_flops, n_matmul = train_flops(cfg, tokens)
    share = flops / (t_step * PEAK_BF16_PER_S)
    log(f"phase 22a: {cfg.name} {cfg.n_layers} of {full.n_layers} layers "
        f"(d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}), {n_params} parameters, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} ({tokens} tokens a step), lr "
        f"{TRAIN_LR}: {steps} steps in {wall:.2f} s; a packed step (steps "
        f"1-{TRAIN_STREAM}) median {t_step:.4f} s: packing on the card "
        f"{pack:.4f}; steps 1-{steps - 1} median forward/backward "
        f"{med('t_grad'):.4f}, update {med('t_update'):.4f}; "
        f"{tokens / t_step:.1f} tokens/s;"
        f" peak {peak / 1e9:.3f} GB; model FLOPs {flops:.4e} a step "
        f"(N_matmul {n_matmul}; the plain attention's {attn_flops:.4e} "
        f"besides), share of the bf16 peak {share:.4f}; launches {counts} "
        f"({counts['prefix_scan'] / (TRAIN_STREAM + 1):.2f} prefix_scan a "
        f"packed batch); losses {losses}")
    return dict(launches=counts, t_step=t_step, share=share, peak=peak,
                steps=steps)


# kernels the profiler names for the dense products (cuBLAS's and
# CUTLASS's) and for the optimizer's and casts' elementwise work
MATMUL_KERNELS = r"gemm|gemv|nvjet|xmma|cutlass"


def profile_train_step(cfg, model, opt, batch, dev):
    """One more training step of phase 22a's model on its repeated batch
    under torch.profiler, after the counted run: the device's busy and
    idle shares, the dense products' share of the device time, and the
    kernels with the most time."""
    import re
    import torch
    from repro_torch.train import AdamWConfig, make_train_step
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup=1,
                                            total_steps=1))
    tensors = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    t0 = time.perf_counter()
    prof, _ = profiled(lambda: step(model, opt, tensors))
    wall = time.perf_counter() - t0
    events = device_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    mm = sum(e.time_range.elapsed_us() for e in events
             if re.search(MATMUL_KERNELS, e.name)) / 1e6
    log(f"phase 22a profiled step: device busy {busy:.4f} s, of it dense "
        f"products {mm:.4f} s ({mm / busy:.4f}), the rest {busy - mm:.4f} "
        f"s")
    trace_summary("22a train step", prof, wall, top_dev=12)


def smoke_train_batch(cfg, dev):
    """``data.random_batch(cfg)`` (2 rows x 64 positions, seed 0) on
    ``dev``."""
    import torch
    from repro_torch.data import random_batch
    return {k: torch.as_tensor(v, device=dev)
            for k, v in random_batch(cfg).items()}


# Gradients of bf16 products through ``layers._ProductF32``, leaf by leaf,
# each as a share of the leaf's max |g| on the other route:
# - against the 'emulated' route (the same forward bits; the backward's
#   products in float32 of the cotangent rounded to bf16, as
#   ``_ProductF32`` rounds it): within 2^-6, four steps of bf16's 2^-8
#   (the two differ only by summation order and the outputs' rounding);
# - against plain autograd on operands upcast to float32 (the CPU's
#   route): within 2^-5.  Two bf16 runs of these models that differ only
#   in summation order and in the cotangent's rounding, neither through
#   ``_ProductF32``, land up to 1.9e-2 apart on an H100 (recurrentgemma's
#   SMOKE config; the check prints this floor, emulated against plain,
#   beside its own): 2^-6 is below the floor of bf16 training here.
# A wrong, swapped or dropped operand gradient is off by its own size.
PRODUCT_GRAD_TOL = {"emulated": 2.0 ** -6, "plain": 2.0 ** -5}


def product_route_grads(loss_of, leaves):
    """The gradients of ``loss_of()`` with respect to ``leaves`` by three
    routes of the bf16 products that ``matmul_f32`` / ``bmm_f32`` send to
    ``_ProductF32`` on the card: 'through' it (``torch.mm`` / ``bmm`` with
    ``out_dtype=float32``; the backward's products in bf16 of the float32
    cotangent rounded to bf16); 'emulated' (the same forward; the
    backward's products in float32 of the cotangent rounded to bf16 and
    back, rounded to the operands' type); 'plain' (the operands upcast,
    plain autograd, the CPU's route).  Returns ({route: grads}, the
    number of products the first run sent through ``_ProductF32``)."""
    import torch
    from repro_torch.models import layers
    own, calls, f32 = layers._ProductF32, [0], torch.float32

    def mm(a, b, **kw):
        return (torch.bmm if a.dim() == 3 else torch.mm)(a, b, **kw)

    class Emulated(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return mm(a, b, out_dtype=f32)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            g = g.to(a.dtype).to(f32)
            return (mm(g, b.to(f32).transpose(-1, -2)).to(a.dtype),
                    mm(a.to(f32).transpose(-1, -2), g).to(b.dtype))

    def through(a, b):
        calls[0] += 1
        return own.apply(a, b)

    routes = {"through": through, "emulated": Emulated.apply,
              "plain": lambda a, b: mm(a.to(f32), b.to(f32))}
    out = {}
    for name, route in routes.items():
        layers._ProductF32 = type("Route", (), {"apply": staticmethod(route)})
        try:
            out[name] = torch.autograd.grad(loss_of(), leaves)
        finally:
            layers._ProductF32 = own
    return out, calls[0]


def check_product_grads(names, grads, calls, label):
    """Every leaf's gradient through ``_ProductF32`` against the emulated
    and the plain route, each within its PRODUCT_GRAD_TOL, in the leaf's
    type and shape.  Returns {route: (worst leaf, its error)}."""
    import torch
    check(calls > 0, f"{label}: no product went through _ProductF32")

    def worst_leaf(got, want):
        errs = {}
        for n, g, w in zip(names, got, want):
            check(g is not None and g.dtype == w.dtype
                  and g.shape == w.shape,
                  f"{label}: {n}'s gradient is missing or of another type")
            w32 = w.to(torch.float32)
            errs[n] = float((g.to(torch.float32) - w32).abs().max()) / max(
                float(w32.abs().max()), 1e-30)
        n = max(errs, key=errs.get)
        return n, errs[n]

    worst = {}
    for route, tol in PRODUCT_GRAD_TOL.items():
        n, err = worst[route] = worst_leaf(grads["through"], grads[route])
        check(err <= tol, f"{label}: {n}'s gradient differs from the "
              f"{route} route by {err:.3e} of its max |g| (limit {tol:.3e})")
    floor = worst_leaf(grads["emulated"], grads["plain"])
    log(f"{label}: {len(names)} gradient leaves through _ProductF32 "
        f"({calls} products); worst against the emulated route "
        f"{worst['emulated'][0]} {worst['emulated'][1]:.3e} of its max |g| "
        f"(limit {PRODUCT_GRAD_TOL['emulated']:.3e}), against plain "
        f"autograd on upcast operands {worst['plain'][0]} "
        f"{worst['plain'][1]:.3e} (limit {PRODUCT_GRAD_TOL['plain']:.3e}); "
        f"emulated against plain, no _ProductF32: {floor[0]} "
        f"{floor[1]:.3e}")
    return worst


def smoke_product_grads(arch, dev):
    """``arch``'s SMOKE config in bf16 on the card: every parameter's
    gradient of ``loss_fn`` through ``_ProductF32`` against the emulated
    and plain routes (``product_route_grads``), from the same weights and
    batch."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model, loss_fn
    cfg = get_smoke(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    model = init_model(cfg, seed=0, device=dev).requires_grad_(True)
    batch = smoke_train_batch(cfg, dev)
    names, leaves = zip(*model.named_parameters())
    grads, calls = product_route_grads(lambda: loss_fn(model, batch, cfg),
                                       leaves)
    return check_product_grads(names, grads, calls,
                               f"smoke {arch} bf16 gradients")


def layer_product_grads(model, tokens, labels, cfg):
    """Phase 22a's model: layer 0, the final norm and the LM head at full
    width on one row, bf16, the loss ``_masked_ce`` of the layer's output;
    every gradient (and the layer input's) through ``_ProductF32``
    against the emulated and plain routes (``product_route_grads``)."""
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import (_masked_ce, block_apply,
                                                decoder_inputs)
    import torch
    with torch.no_grad():
        x0, pos, pos3 = decoder_inputs(model, tokens, cfg)
    x0.requires_grad_(True)
    layer = model.layers[0]

    def loss_of():
        x, _ = block_apply(layer, x0, cfg, pos, pos3)
        return _masked_ce(model.embed.head, rmsnorm(x, model.ln_f), labels,
                          cfg)

    named = [(f"layers.0.{n}", p) for n, p in layer.named_parameters()]
    named += [("ln_f", model.ln_f), ("embed.head", model.embed.head),
              ("layer input", x0)]
    names, leaves = zip(*named)
    grads, calls = product_route_grads(loss_of, leaves)
    return check_product_grads(
        names, grads, calls, f"phase 22a: {cfg.name} layer 0 and head "
        f"at full width ({tokens.shape[0]} x {tokens.shape[1]} tokens)")


def pack_card_vs_cpu(dev):
    """Phase 22b: ``pack_batches`` of phase 22a's corpus on the card and on
    the CPU, every batch equal bit for bit; ``balanced_pack`` with
    'sorted' and 'ksection' at PACK_LENGTHS lognormal lengths and p =
    PACK_ROWS (the reference's test shape), with and without old rows,
    equal to the CPU's parts and metrics.  Every input the packer handed
    ``prefix_scan`` and ``ksection_hist`` on the card is held against the
    plain version; the launches of the corpus pass and of the packs are
    returned for the kernels line."""
    import numpy as np
    from repro_torch.data import SyntheticCorpus, balanced_pack, pack_batches
    from repro_torch.kernels import ops
    docs = SyntheticCorpus(vocab=128256, seed=1).documents(2048)
    keep_scan = lambda x, **kw: x.detach().clone()  # noqa: E731
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_calls(ops, "exclusive_scan_op", keep_scan) as scans:
        card = list(pack_batches(docs, TRAIN_BATCH, TRAIN_SEQ, vocab=128256,
                                 device=dev))
    t_card = time.perf_counter() - t0
    corpus = ops.launch_counts()
    check_scan_agreement(scans, corpus["prefix_scan"], "phase 22b corpus")
    t0 = time.perf_counter()
    cpu = list(pack_batches(docs, TRAIN_BATCH, TRAIN_SEQ, vocab=128256,
                            device="cpu"))
    t_cpu = time.perf_counter() - t0
    check(len(card) == len(cpu), "pack_batches: another number of batches")
    for i, (a, b) in enumerate(zip(card, cpu)):
        check(np.array_equal(a["tokens"], b["tokens"])
              and np.array_equal(a["labels"], b["labels"]),
              f"pack_batches: batch {i} differs between card and CPU")
    check(corpus["prefix_scan"] >= len(card), f"{corpus['prefix_scan']} "
          f"prefix_scan launches for {len(card)} packed batches")
    log(f"phase 22b: {len(card)} batches of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"equal bit for bit, card {t_card:.3f} s ({corpus['prefix_scan']} "
        f"prefix_scan launches), CPU {t_cpu:.3f} s")
    by_method = {}
    ops.reset_launch_counts()
    with recorded_calls(ops, "exclusive_scan_op", keep_scan) as scans, \
            recorded_hist_inputs() as hists:
        for method, kernel in (("sorted", "prefix_scan"),
                               ("ksection", "ksection_hist")):
            before = ops.launch_counts()[kernel]
            for seed in range(PACK_SEEDS):
                rng = np.random.default_rng(seed)
                lengths = np.maximum(8, rng.lognormal(
                    5.0, 0.8, PACK_LENGTHS)).astype(np.int64)
                old = None
                for _ in range(2):
                    got = balanced_pack(lengths, PACK_ROWS, old_rows=old,
                                        method=method, device=dev)
                    want = balanced_pack(lengths, PACK_ROWS, old_rows=old,
                                         method=method, device="cpu")
                    check(np.array_equal(got[0], want[0])
                          and got[1] == want[1],
                          f"balanced_pack {method} seed {seed}: card "
                          f"{got[1]} against CPU {want[1]}")
                    old = got[0]
                    lengths = lengths.copy()
                    lengths[:10] += 50
            by_method[method] = ops.launch_counts()[kernel] - before
            check(by_method[method] > 0, f"balanced_pack {method}: {kernel} "
                  "was not launched")
    packs = ops.launch_counts()
    check_scan_agreement(scans, packs["prefix_scan"], "phase 22b packs")
    check_hist_agreement(hist_agreement(hists), packs["ksection_hist"],
                         "phase 22b packs")
    log(f"phase 22b: balanced_pack ({PACK_LENGTHS} lengths, p = "
        f"{PACK_ROWS}, {PACK_SEEDS} seeds, fresh and with old rows) equal "
        f"to the CPU; launches {by_method}")
    return dict(batches=len(card), corpus_launches=corpus,
                pack_launches=packs)


def smoke_train_card_vs_cpu(arch, compress, dev):
    """``arch``'s SMOKE config in float32: SMOKE_TRAIN_STEPS
    ``make_train_step`` steps (with EF compression if ``compress``) on the
    card and on the CPU from the same weights and batch: losses within
    SMOKE_LOSS_RTOL relative, parameters after the first step within 2 lr
    + 1e-5 (AdamW's first step moves a weight by about lr times the sign
    of its gradient, which a gradient near 0 may have either way)."""
    import copy
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    from repro_torch.train import (AdamWConfig, init_compress_state,
                                   init_opt_state, make_train_step)
    ocfg = AdamWConfig(lr=SMOKE_TRAIN_LR, warmup=1,
                       total_steps=SMOKE_TRAIN_STEPS)
    cfg = get_smoke(arch)
    cpu_model = init_model(cfg, seed=0, device="cpu")
    runs = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        model = copy.deepcopy(cpu_model).to(d) if side == "card" else cpu_model
        step = make_train_step(cfg, ocfg, compress=compress)
        opt = init_opt_state(model, ocfg)
        comp = init_compress_state(model) if compress else None
        batch = smoke_train_batch(cfg, d)
        losses, first = [], None
        for i in range(SMOKE_TRAIN_STEPS):
            if compress:
                model, opt, comp, m = step(model, opt, batch, comp)
            else:
                model, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
            if i == 0:
                first = {n: p.detach().cpu().clone()
                         for n, p in model.named_parameters()}
        runs[side] = losses, first
    (lc, pc), (lh, ph) = runs["card"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    worst = max(pc, key=lambda n: float((pc[n] - ph[n]).abs().max()))
    moved = float((pc[worst] - ph[worst]).abs().max())
    label = f"smoke {arch}{' compressed' if compress else ''} train"
    check(rel <= SMOKE_LOSS_RTOL, f"{label}: losses {lc} against {lh}")
    check(moved <= 2 * ocfg.lr + 1e-5, f"{label}: {worst} after step 1 "
          f"differs by {moved:.3e}")
    log(f"{label} card vs CPU (float32): losses {lc}, worst relative "
        f"{rel:.3e} (limit {SMOKE_LOSS_RTOL}); parameters after step 1 "
        f"within {moved:.3e} (limit {2 * ocfg.lr + 1e-5:.3e})")


def checkpoint_resume_on_card(dev, path):
    """The SMOKE llama on the card after two steps, saved under ``path``
    and restored into a model of other weights: parameters, moments and
    step bit for bit; a step from the restored state equal to the
    unbroken run's, bit for bit."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step, restore, save)
    cfg = get_smoke("llama3_8b")
    ocfg = AdamWConfig(lr=SMOKE_TRAIN_LR, warmup=1, total_steps=4)
    step = make_train_step(cfg, ocfg)
    batch = smoke_train_batch(cfg, dev)
    model = init_model(cfg, seed=0, device=dev)
    opt = init_opt_state(model, ocfg)
    for _ in range(2):
        model, opt, _ = step(model, opt, batch)
    save(path, 2, {"params": model, "opt": opt})
    fresh = init_model(cfg, seed=3, device=dev)
    _, state = restore(path, template={"params": fresh,
                                       "opt": init_opt_state(fresh, ocfg)})
    own = dict(fresh.named_parameters())
    check(all(torch.equal(own[n], p) and torch.equal(state["opt"].m[n],
                                                     opt.m[n])
              and torch.equal(state["opt"].v[n], opt.v[n])
              for n, p in model.named_parameters())
          and state["opt"].step == opt.step,
          "the restored checkpoint differs from the saved state")
    model, _, m = step(model, opt, batch)
    fresh, _, m2 = step(fresh, state["opt"], batch)
    check(float(m["loss"]) == float(m2["loss"]) and all(
        torch.equal(p, q) for p, q in zip(model.parameters(),
                                          fresh.parameters())),
          "a resumed step differs from the unbroken one")
    log("smoke llama3-8b checkpoint on the card: restored bit for bit, the "
        "resumed step equal to the unbroken one")


def train_card_vs_cpu(dev):
    """Phase 22c: every architecture's SMOKE config in float32, card
    against CPU (``smoke_train_card_vs_cpu``), llama once more with
    compression; every architecture's SMOKE config in bf16, its gradients
    through ``_ProductF32`` against the emulated and plain routes
    (``smoke_product_grads``); a checkpoint of the card's llama restored
    and resumed bit for bit."""
    import shutil
    from repro_torch.configs import ARCH_IDS
    for arch, compress in ([(a, False) for a in ARCH_IDS]
                           + [("llama3_8b", True)]):
        smoke_train_card_vs_cpu(arch, compress, dev)
    for arch in ARCH_IDS:
        smoke_product_grads(arch, dev)
    path = os.path.join(ROOT, "build", "train_checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    checkpoint_resume_on_card(dev, path)


# ---------------------------------------------------------------------------

FEM_KERNELS = ("sfc_keys", "ksection_hist", "fem_matvec")
SRC = "src/repro_torch/kernels/csrc/"
# the source of the kernel each row times and counts: the path's attention
# is bf16, so flash_attention's row is the tensor-core kernel
SOURCES = {"flash_attention": "flash_attention_tc.cu"}
REPLACES = {"sfc_keys": "src/repro/kernels/sfc_keys.py:88",
            "ksection_hist": "src/repro/kernels/ksection_hist.py:95",
            "fem_matvec": "src/repro/kernels/fem_matvec.py:108",
            "prefix_scan": "src/repro/kernels/prefix_scan.py:47",
            "flash_attention": "src/repro/kernels/flash_attention.py:84",
            "serve_prefill": "src/repro/kernels/serve_prefill.py:109"}
FAILED = []


def phase(name, fn, *args):
    """Run one phase; a failure is printed and recorded, and the script
    goes on to the next phase so that one run shows every check.  Any
    recorded failure makes the script exit non-zero at the end."""
    log(f"== {name}")
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except Exception as e:      # reported, and fails the run at the end
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        log(f"== {name}: FAILED ({e!r})")
        FAILED.append(name)
        return None
    log(f"== {name}: done in {time.perf_counter() - t0:.1f} s")
    return out


def fem_kernel_rows(res, session, balanced, dev):
    """Phases 3-5 of the FEM path: its kernels at the session's shapes,
    the fixed-order segment sum's cost, the balance replay and the
    standalone DLB step."""
    import torch
    from repro_torch.core.sfc import sfc_keys
    # keys and histogram at the shapes of the session's last
    # repartition, the matvec at its last solve's
    log(f"kernel shapes: keys and histogram from step {balanced['step']} "
        f"(n={len(balanced['coords'])}), matvec from the last mesh")
    rows = {}
    rows["sfc_keys"], coords, lo, hi = compare_sfc(balanced["coords"], dev)
    keys = sfc_keys(coords, lo, hi).to(torch.float32)
    kf, wf = pad_pow2(keys, torch.ones_like(keys))
    rows["ksection_hist"] = compare_hist(kf.contiguous(), wf.contiguous(),
                                         64, "p=64")
    compare_hist(kf.contiguous(), wf.contiguous(), 1024, "p=1024")
    rows["fem_matvec"] = compare_matvec(res.mesh, dev)
    compare_sums(res.mesh, dev)
    replay_balance(res, session, dev)
    standalone_dlb(dev)
    return rows


def attention_rows(serve, dev):
    """Both attention kernels against their plain versions: flash in bf16
    (tensor cores) at the path's prompt length (128) and at 1024, and in
    float32 (CUDA cores) at 128; packed in bf16 (tensor cores) on a full
    buffer of requests of 1024, 512, 256, 128 and 128 tokens (a reading
    beside flash at 1024) and on the session's fullest buffer (only when
    the serving phase gave one: without it the run fails anyway)."""
    compare_flash(dev, 1024)
    compare_flash(dev, 128, "float32")
    rows = {"flash_attention": compare_flash(dev, 128)}
    compare_packed(dev, full_buffer_seg(), "a full buffer, a reading")
    if serve is not None:
        rows["serve_prefill"] = compare_packed(dev, serve["fullest_pack"])
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    # float32 products in full float32 on the card (the PyTorch defaults,
    # stated): the smoke-size comparison with the CPU relies on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({build.library_path().name})")
    log_path = build.BUILD_DIR / "build.log"
    if log_path.exists():
        for line in kernel_resources(log_path.read_text()):
            log("  " + line)

    fem = phase("phase 2: the adaptive FEM session (main path 1)",
                run_session, dev)
    phase("phase 2b: small session, card twice and against CPU",
          small_session_agreement, dev)
    rows = {}
    if fem is not None:
        rows.update(phase("phases 3-5: FEM kernels, balance replay, "
                          "standalone DLB", fem_kernel_rows, fem[0], fem[1],
                          fem[3], dev) or {})
    serve = phase("phases 6-7: serving at llama3-8b width (main path 2: "
                  "packed; then packed against full)", serve_full_width, dev)
    phase("phase 8: serving at smoke size, card against CPU",
          serve_card_vs_cpu, dev)
    if serve is not None:
        phase("phase 8b: the bf16 MLP at llama3-8b width, card against CPU",
              compare_mlp, serve, dev)
    rows.update(phase("phase 9a: attention kernels against plain versions",
                      attention_rows, serve, dev) or {})
    if serve is not None:
        phase("phase 9b: profile of one packed admission and 8 decode steps",
              profile_serving, serve, dev)
    phase("phase 10: standalone sharded DLB (8M points, p = 4)", sharded_dlb)
    sharded = phase("phase 11: the sharded adaptive session (main path 3)",
                    sharded_session)
    if sharded is not None:
        scan_row = phase("phase 12: prefix_scan against its plain version "
                         "at the sharded session's shard lengths",
                         compare_scan, dev, sharded["scanned"])
        if scan_row is not None:
            rows["prefix_scan"] = scan_row
    served = None
    if serve is not None:
        served = phase("phase 13: sharded serving with KV migration at "
                       "llama3-8b width (main path 4)", sharded_serving,
                       serve)
        serve.pop("model")          # the card's memory for phases 14-17
        free_memory()
        log(f"after freeing phase 6's model: "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    log(f"command time so far: {time.perf_counter() - t_start:.1f} s")
    swa = phase("phase 14: sliding window at h2o-danube3-4b width and depth "
                "(full prefill over a ring of 4096)", serve_swa, dev)
    phase("phase 14b: h2o-danube3 SMOKE with a ring, card against CPU",
          serve_card_vs_cpu, dev, "h2o_danube3_4b", "full", RING_BUCKETS)
    dense = phase("phase 15: h2o-danube-1.8b and command-r-plus at full "
                  "width, packed against full", serve_dense_widths, dev)
    phi = phase("phase 16: phi3.5-moe at full width (the MoE path)",
                serve_phi, dev)
    for prefill in ("packed", "full"):
        phase(f"phase 16b: phi3.5-moe SMOKE {prefill}, card against CPU",
              serve_card_vs_cpu, dev, "phi35_moe_42b", prefill)
    grok = phase("phase 17: grok-1 at full width (soft cap 30, packed)",
                 serve_grok, dev)
    phase("phase 17b: grok-1 SMOKE packed, card against CPU",
          serve_card_vs_cpu, dev, "grok_1_314b", "packed")
    t_new = time.perf_counter()
    log(f"command time so far: {t_new - t_start:.1f} s")
    mamba = phase("phase 18: mamba2-1.3b at full width and depth (the SSM "
                  "path, full prefill)", serve_mamba2, dev)
    phase("phase 18 SMOKE: mamba2 full, card against CPU",
          serve_card_vs_cpu, dev, "mamba2_1_3b", "full")
    mamba_sharded = None
    if mamba is not None:
        mamba_sharded = phase(
            "phase 18b: mamba2-1.3b sharded with KV-slot migration over 4 "
            "ranks", sharded_serving, mamba, MAMBA_SHARDED_SPEC,
            "phase 18's replicated full run")
        mamba.pop("model")
        free_memory()
    hybrid = phase("phase 19: recurrentgemma-2b at full width and depth "
                   "(full prefill over a ring of 2048, flash at d = 256)",
                   serve_hybrid, dev)
    phase("phase 19 SMOKE: recurrentgemma with a ring, card against CPU",
          serve_card_vs_cpu, dev, "recurrentgemma_2b", "full", RING_BUCKETS)
    log(f"phases 18-19: {time.perf_counter() - t_new:.1f} s; command time "
        f"so far: {time.perf_counter() - t_start:.1f} s")
    t_new = time.perf_counter()
    whisper = phase("phase 20: whisper-medium at full width and depth (the "
                    "encoder-decoder: batch API, cheap session, flash at "
                    "the encoder's and cross-attention's shapes)",
                    serve_whisper, dev)
    phase("phase 20c: whisper SMOKE batch API, card against CPU",
          encdec_card_vs_cpu, dev)
    phase("phase 20c: whisper SMOKE cheap, card against CPU",
          serve_card_vs_cpu, dev, "whisper_medium", "cheap")
    vlm = phase("phase 21: qwen2-vl-72b at full width (M-RoPE, full "
                "prefill; the VLM front end)", serve_qwen2_vl, dev)
    free_memory()
    phase("phase 21c: qwen2-vl SMOKE full, card against CPU",
          serve_card_vs_cpu, dev, "qwen2_vl_72b", "full")
    log(f"phases 20-21: {time.perf_counter() - t_new:.1f} s; command time "
        f"so far: {time.perf_counter() - t_start:.1f} s")
    t_new = time.perf_counter()
    training = phase("phase 22a: training at llama3-8b width (main path 5: "
                     "launch.train.train, the packer on the card)",
                     train_full_width, dev)
    packing = phase("phase 22b: the training packer, card against CPU",
                    pack_card_vs_cpu, dev)
    phase("phase 22c: SMOKE training of every architecture, card against "
          "CPU; checkpoint and resume on the card", train_card_vs_cpu, dev)
    log(f"phase 22: {time.perf_counter() - t_new:.1f} s; command time so "
        f"far: {time.perf_counter() - t_start:.1f} s")
    if (FAILED or fem is None or serve is None or sharded is None
            or served is None
            or None in (swa, dense, phi, grok, mamba, mamba_sharded, hybrid,
                        whisper, vlm, training, packing)
            or len(rows) < len(REPLACES)):
        log(f"FAILED phases: {FAILED}")
        return 1
    # each path's launches, counted from 0 over its own run; main path
    # 4's per rank (phase 13's trace); phases 14-21's per path
    launches = {**{k: fem[2][k] for k in FEM_KERNELS},
                "prefix_scan": sharded["launches"]["prefix_scan"],
                "serve_prefill": serve["packed"][1]["serve_prefill"],
                "flash_attention": serve["full"][1]["flash_attention"]}
    paths = {"h2o_danube3_4b full (window 4096)": swa["launches"],
             **{f"{arch} {mode}": c for arch, d in dense.items()
                for mode, c in d["launches"].items()},
             **{f"phi35_moe_42b {mode}": c
                for mode, c in phi["launches"].items()},
             "grok_1_314b packed": grok["launches"]["packed"],
             "mamba2_1_3b full": mamba["launches"],
             "mamba2_1_3b full, prompts of 4608-6144": mamba["long_launches"],
             "mamba2_1_3b sharded (per rank)": mamba_sharded["launches"],
             "recurrentgemma_2b full (window 2048)": hybrid["launches"],
             "recurrentgemma_2b full (phase 6's trace)":
                 hybrid["short_launches"],
             "whisper_medium batch API (16 x 1500 frames, 64 steps)":
                 whisper["batch_launches"],
             "whisper_medium cheap (phase 6's trace)": whisper["launches"],
             "qwen2_vl_72b full (phase 6's trace)": vlm["launches"],
             "qwen2_vl_72b batch API (4 x 256 patches, 8 steps)":
                 vlm["batch_launches"],
             f"llama3_8b train ({TRAIN_DEPTH} layers, {TRAIN_BATCH} x "
             f"{TRAIN_SEQ}, {training['steps']} steps)": training["launches"],
             f"training packer, corpus pass ({packing['batches']} batches)":
                 packing["corpus_launches"],
             f"balanced_pack sorted and ksection ({PACK_LENGTHS} lengths, p "
             f"= {PACK_ROWS}, {PACK_SEEDS} seeds x 2)":
                 packing["pack_launches"]}
    # the flash kernel at the hybrid's head dim and at whisper's encoder
    # and cross-attention shapes, beside its main-path row
    d256 = dict(hybrid["row"], shape="b=1 hq=10 hkv=1 s=6144 d=256 causal "
                "window=2048 bf16")
    w = whisper["rows"]
    encdec = {
        "at_encoder": dict(w["encoder"], shape="b=16 hq=16 hkv=16 s=1500 "
                           "s_kv=1500 d=64 no mask bf16"),
        "at_cross_prefill": dict(w["cross_prefill"], shape="b=16 hq=16 "
                                 "hkv=16 s=128 s_kv=1500 d=64 no mask bf16"),
        "at_cross_decode": dict(w["cross_decode"], shape="b=16 hq=16 hkv=16 "
                                "s=1 s_kv=1500 d=64 no mask bf16"),
        "at_qwen2_vl": {f"s={n}": dict(r, shape=f"b=1 hq=64 hkv=8 s={n} d=128 "
                                       "causal bf16")
                        for n, r in vlm["flash_rows"].items()}}
    table = [dict(name=name, route="cuda", source=SRC + SOURCES.get(name, name + ".cu"),
                  replaces=REPLACES[name], launches=launches[name],
                  max_abs_err=rows[name]["max_abs_err"], ms=rows[name]["ms"],
                  plain_ms=rows[name]["plain_ms"],
                  bound_ms=rows[name]["bound_ms"],
                  bound_by=rows[name]["bound_by"],
                  library_ms=rows[name]["library_ms"],
                  launches_sharded_serving=[
                      r[name] for r in served["launches"]],
                  launches_by_path={
                      p: [r[name] for r in c] if isinstance(c, list)
                      else c[name] for p, c in paths.items()},
                  **({"at_head_dim_256": d256, **encdec}
                     if name == "flash_attention" else {}))
             for name in REPLACES]
    log(json.dumps({"kernels": table}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
