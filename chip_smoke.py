#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  It

1. prints the card and builds the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` (into ``build/kernels``);
2. drives the first main path -- an adaptive Helmholtz session (paper
   Example 3.1) from 786,432 tets with incremental k-section balancing on
   64 parts -- and checks that each of its kernels was launched; its
   first two steps run under torch.profiler, whose summary gives the
   device's idle share and where the host time goes; then runs a
   smoke-size session on the card twice (equal bit for bit at every
   step: the FEM's sums add in a fixed order) and replays each of its
   steps on the CPU from the card's mesh;
3. holds the FEM path's kernels against their plain PyTorch versions at
   the session's shapes, timing both by the device time torch.profiler
   records (and, with host dispatch, by CUDA events); the element matvec
   also for equal bits over two calls, with its plan's build time;
4. replays the last balance with the kernels and with the plain versions
   (every field equal);
5. runs the standalone DLB step at scale: 8M points, p = 1024, hsfc and
   msfc x sorted and k-section, kernels against plain versions;
6. drives the second main path: the serving session at llama3-8b width
   (random bf16 weights from a seed, 16 slots x 2048 tokens, 4 groups)
   over a seeded 32-request bursty trace with packed prefill, replicated
   decode and tag rebalancing, and prints throughput, TTFT, ITL,
   admission rate, buffer fill, each rebalance and the peak memory;
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
13. prints the kernel table as one JSON line, the card's name and power
    limit, and ``{"ok": true, ...}`` as the last line.

Ranks: with 4 or more cards, one rank per card over NCCL; with fewer,
the 4 ranks share cuda:0 and their collectives go through gloo, staged
through host memory (the script prints which).  The kernels are built
before any rank starts, so the ranks only load the library.

A failed check is printed and the run goes on to the next phase; at the
end, any failure makes the script exit 1 without the last two lines.
Without CUDA it exits 2 before doing anything.
"""
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


def trace_summary(label, prof, wall_s, top_host=8, top_dev=5):
    """Device busy share of a profiled window, the host ops with the most
    self time and the device kernels with the most time."""
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
    log(f"trace {label}: wall {wall_s:.4f} s, device busy {busy_s:.4f} s "
        f"(summed event durations), idle share {1 - busy_s / wall_s:.4f}")
    for kind, table, top in (("host self", host, top_host),
                             ("device", dev, top_dev)):
        for name, (t, c) in sorted(table.items(), key=lambda kv: -kv[1][0]
                                   )[:top]:
            log(f"  {kind} {t / 1e3:10.3f} ms  x{c:<6d} {name[:90]}")


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

    def open_window():
        window["prof"] = profile(activities=acts)
        window["prof"].start()
        window["t0"] = time.perf_counter()

    def on_step(stats, state):
        t_hook = time.perf_counter()
        if state.step < TRACED_STEPS:
            torch.cuda.synchronize()
            window["prof"].stop()
            traces.append((state.step, window["prof"], t_hook - window["t0"]))
            window["prof"] = None
        per_step.append(dict(ops.launch_counts()))
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
            f"{ {k: c[k] - prev[k] for k in c} }")
        prev = c
    for step, prof, wall_s in traces:
        trace_summary("session start to the end of step 0" if step == 0
                      else f"step {step}", prof, wall_s)
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
        plain_ms, plain_call_ms = timed_ms(lambda: plain(grid), reps=5)
        bound = 16 * n / PEAK_BYTES_PER_S * 1e3
        log(f"sfc_keys[{curve}] n={n}: kernel_ms={ms:.4f} (call "
            f"{call_ms:.4f}) plain_ms={plain_ms:.4f} (call "
            f"{plain_call_ms:.4f}) bound_ms={bound:.4f} equal=True")
        if curve == "hilbert":   # the main path's curve (method hsfc)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by="bytes", library_ms=None, max_abs_err=0.0)
    return row, coords, lo, hi


def compare_hist(kf, w, p, label):
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
    plain_ms, plain_call_ms = timed_ms(
        lambda: [ref.ksection_histogram_ref(kf, w, c) for c in seq], reps=5)
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
        f"{ms:.4f} (call {call_ms:.4f}) plain_ms={plain_ms:.4f} (call "
        f"{plain_call_ms:.4f}) bound_ms={bound:.4f} ({by}; bytes "
        f"{t_bytes:.4f}, ops {t_ops:.4f}) equal=True per call")
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
    check(torch.equal(fixed, segment_sum(x, ids, el.n_verts)),
          "segment_sum: two calls differ on the card")
    atomic = segment_sum_any_order(x, ids, el.n_verts)
    rel = float((fixed - atomic).abs().max() / atomic.abs().max())
    ms, call_ms = timed_ms(lambda: segment_sum(x, ids, el.n_verts), reps=5)
    order = SegmentOrder(ids, el.n_verts)
    apply_ms, apply_call = timed_ms(lambda: order.sum(x), reps=5)
    any_ms, any_call = timed_ms(
        lambda: segment_sum_any_order(x, ids, el.n_verts), reps=5)
    log(f"segment_sum fixed order, {ids.numel()} contributions into "
        f"{el.n_verts} vertices: device {ms:.4f} ms (call {call_ms:.4f}), "
        f"of which the sum on a built order {apply_ms:.4f} (call "
        f"{apply_call:.4f}) and {len(order.steps)} tree steps; index_add_ "
        f"{any_ms:.4f} (call {any_call:.4f}); bit-identical over two calls; "
        f"max |fixed - index_add_| / max|sum| = {rel:.3e}")


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
    return compare_hist(kf.contiguous(), wf.contiguous(), 1024, "p=1024")


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

    def on_step(stats, state):
        if state.step == PROFILED_STEP:
            sync(dev)
            window["prof"].stop()
            window["wall"] = time.perf_counter() - window["t0"]
        if state.step + 1 == PROFILED_STEP:
            sync(dev)
            window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()

    session = AdaptiveSession(spec, comm=comm, on_step=on_step,
                              on_state=on_state)
    sync(dev)
    staged0 = comm.staged_bytes
    ops.reset_launch_counts()
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
                      window["prof"], window["wall"])

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
            rhs_equal=rhs_equal,
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
            f"rank 0's bit for bit")
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


def serve_run(model, cfg, dev, spec_kw, trace, record=False):
    """One ``run_trace`` of a fresh session, the launch counts set to 0
    just before it and read just after.  Returns (metrics, requests,
    launch counts, peak bytes, recorder)."""
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
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import bursty_trace
    cfg = get_config("llama3_8b").replace(use_pallas=True)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.name}: {n} parameters ({n * 2 / 1e9:.2f} GB bf16), "
        f"random from seed 0 on the card in {time.perf_counter() - t0:.2f} s")
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
    m, reqs, counts, peak, _ = serve_run(model, cfg, dev, SERVE_SPEC, trace)
    from repro_torch.kernels.serve_prefill import packed_attention_cuda
    packed_variants = dict(packed_attention_cuda.variants)
    log_serve("packed, the main path", m, counts, peak)
    log(f"  serve_prefill launches by variant: {packed_variants}")
    check(counts["serve_prefill"] > 0, "serve_prefill was not launched")
    check(packed_variants["bf16_tensor_core"] == counts["serve_prefill"],
          "the packed prefill's bf16 attention did not run on the tensor "
          "cores at every launch")
    out["packed"] = (m, counts)
    mp, rp, cp, pp, recp = serve_run(model, cfg, dev, SERVE_SPEC, trace,
                                     record=True)
    same = [a.out for a in reqs] == [b.out for b in rp]
    log(f"packed again, recorded: tokens equal to the first run: {same}")
    mf, rf, cf, pf, recf = serve_run(model, cfg, dev,
                                     dict(SERVE_SPEC, prefill="full"), trace,
                                     record=True)
    log_serve("full", mf, cf, pf)
    check(cf["flash_attention"] > 0, "flash_attention was not launched")
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    variants = dict(flash_attention_cuda.variants)
    log(f"  flash_attention launches by variant: {variants}")
    check(variants["bf16_tensor_core"] == cf["flash_attention"],
          "the full prefill's bf16 attention did not run on the tensor cores")
    out["full"] = (mf, cf)
    out["fullest_pack"] = max(recp.packs, key=lambda sg: int((sg >= 0).sum()))
    out["first_err"] = compare_recorded("packed vs full on the card", rp,
                                        recp, rf, recf, BF16_TOL)
    check(mp["migration_log"] == mf["migration_log"],
          "packed and full rebalance differently")
    return out


def serve_card_vs_cpu(dev):
    """Phase 8: SMOKE in float32, the same port weights on both sides; the
    packed session with the kernels on the card against the plain
    versions on the CPU."""
    import copy
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    from repro_torch.serve import bursty_trace
    cfg = get_smoke("llama3_8b").replace(use_pallas=True)
    cpu_model = init_model(cfg, seed=0, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    trace = bursty_trace(24, **SMOKE_TRACE)
    ma, ra, ca, _, reca = serve_run(card_model, cfg, dev, SMOKE_SPEC, trace,
                                    record=True)
    mb, rb, _, _, recb = serve_run(cpu_model, cfg, "cpu", SMOKE_SPEC, trace,
                                   record=True)
    check(ca["serve_prefill"] > 0, "smoke: serve_prefill was not launched")
    compare_recorded("smoke card vs CPU (float32)", ra, reca, rb, recb,
                     F32_TOL)
    check(ma["migration_log"] == mb["migration_log"],
          "smoke: rebalances differ between card and CPU")
    log(f"smoke: {ma['steps']} steps, {ma['tokens']} tokens, "
        f"{len(ma['migration_log'])} rebalances equal, prefill calls "
        f"{ma['prefill_calls']} and {mb['prefill_calls']}")


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


def attention_bound(pairs, hq, hkv, n_in, n_out, d, extra_bytes=0):
    """(bound ms, by): 4 d flops per visible (query, key) pair and head
    over the bf16 tensor-core peak, against the bytes the function must
    move over the memory rate: q, k and v (bf16) read once over the
    ``n_in`` tokens that have a visible key, o written once over all
    ``n_out`` rows."""
    t_ops = 4 * d * pairs / PEAK_BF16_PER_S * 1e3
    t_bytes = (2 * (hq + 2 * hkv) * n_in * d + 2 * hq * n_out * d
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


def compare_flash(dev, s, dtype="bfloat16"):
    """The flash kernel against mha_ref at b = 1, 32 / 8 heads, d = 128,
    causal; SDPA (causal, GQA) as the yardstick.  bf16 runs the
    tensor-core kernel, float32 the CUDA-core one (checked by the
    per-variant counts)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (VARIANTS,
                                                     flash_attention_cuda)
    g = torch.Generator(device=dev).manual_seed(s)
    hq, hkv, d = 32, 8, 128
    dt = getattr(torch, dtype)
    q = torch.randn((1, hq, s, d), generator=g, device=dev).to(dt)
    k = torch.randn((1, hkv, s, d), generator=g, device=dev).to(dt)
    v = torch.randn((1, hkv, s, d), generator=g, device=dev).to(dt)
    variant = VARIANTS[dt]
    before = flash_attention_cuda.variants[variant]
    got = flash_attention_cuda(q, k, v, causal=True)
    check(flash_attention_cuda.variants[variant] == before + 1,
          f"flash_attention {dtype}: the {variant} kernel did not run")
    want = ref.mha_ref(q, k, v, causal=True)
    label = f"flash_attention {dtype} s={s}"
    if dt == torch.bfloat16:
        err, reading = attention_err(label, got, want)
    else:
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1.0)
        check(err <= ATTN_F32_RTOL * scale, f"{label}: max abs err {err} > "
              f"{ATTN_F32_RTOL} * {scale}")
        reading = f"max_abs_err={err:.3e} (limit {ATTN_F32_RTOL * scale:.3e})"
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    lib_err = float((sdpa().float() - want.float()).abs().max())
    ms, call_ms = timed_ms(lambda: flash_attention_cuda(q, k, v, causal=True))
    plain_ms, plain_call = timed_ms(lambda: ref.mha_ref(q, k, v, causal=True),
                                    reps=5)
    lib_ms, lib_call = timed_ms(sdpa)
    bound, by = attention_bound(hq * s * (s + 1) // 2, hq, hkv, s, s, d)
    log(f"flash_attention b=1 hq={hq} hkv={hkv} s={s} d={d} causal {dtype} "
        f"({variant}): kernel_ms={ms:.4f} (call {call_ms:.4f}) plain_ms="
        f"{plain_ms:.4f} (call {plain_call:.4f}) sdpa_ms={lib_ms:.4f} (call "
        f"{lib_call:.4f}) bound_ms={bound:.4f} ({by}, bf16 rates) "
        f"share={bound / ms:.4f} {reading} (sdpa max abs err {lib_err:.3e})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, max_abs_err=err)


def compare_packed(dev, seg_np, label="the path's fullest buffer"):
    """The packed kernel against packed_attention_ref on one packed buffer
    (32 / 8 heads, d = 128, bf16): every element within one bf16 step,
    pad rows exactly 0, the same bits on a second call, on the tensor
    cores; SDPA with a boolean segment-causal mask as the yardstick,
    compared on real rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.serve_prefill import packed_attention_cuda
    C, hq, hkv, d = seg_np.shape[0], 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(C)
    q = _bf16((hq, C, d), g, dev)
    k, v = _bf16((hkv, C, d), g, dev), _bf16((hkv, C, d), g, dev)
    seg = torch.as_tensor(seg_np, dtype=torch.int32, device=dev)
    before = packed_attention_cuda.variants["bf16_tensor_core"]
    got = packed_attention_cuda(q, k, v, seg)
    check(packed_attention_cuda.variants["bf16_tensor_core"] == before + 1,
          "serve_prefill bf16: the tensor-core kernel did not run")
    want = ref.packed_attention_ref(q, k, v, seg)
    err, reading = attention_err("serve_prefill", got, want)
    real = seg >= 0
    check(bool((got[:, ~real] == 0).all()), "serve_prefill: pad rows not 0")
    check(torch.equal(got, packed_attention_cuda(q, k, v, seg)),
          "serve_prefill: two calls differ")
    i = torch.arange(C, device=dev)
    mask = (i[None, :] <= i[:, None]) & (seg[:, None] == seg[None, :]) \
        & real[:, None]
    qb, kb, vb = q[None], k[None], v[None]
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qb, kb, vb, attn_mask=mask, enable_gqa=True)
    lib_err = float((sdpa()[0][:, real].float()
                     - want[:, real].float()).abs().max())
    ms, call_ms = timed_ms(lambda: packed_attention_cuda(q, k, v, seg))
    plain_ms, plain_call = timed_ms(
        lambda: ref.packed_attention_ref(q, k, v, seg), reps=5)
    lib_ms, lib_call = timed_ms(sdpa)
    _, lens = np.unique(seg_np[seg_np >= 0], return_counts=True)
    pairs = hq * int(sum(n * (n + 1) // 2 for n in lens.tolist()))
    n_real = int(real.sum())
    bound, by = attention_bound(pairs, hq, hkv, n_real, C, d,
                                extra_bytes=4 * C)
    log(f"serve_prefill ({label}) C={C} hq={hq} hkv={hkv} d={d} bf16, "
        f"segments {lens.tolist()} ({n_real} real tokens, {pairs} visible "
        f"pairs over the heads): kernel_ms="
        f"{ms:.4f} (call {call_ms:.4f}) plain_ms={plain_ms:.4f} (call "
        f"{plain_call:.4f}) sdpa_ms={lib_ms:.4f} (call {lib_call:.4f}) "
        f"bound_ms={bound:.4f} ({by}) share={bound / ms:.4f} {reading} "
        f"(sdpa max abs err on real rows {lib_err:.3e}); bit-identical "
        f"over two calls, pad rows 0")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, max_abs_err=err)


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

    prof, (session, wall) = profiled(body, setup)
    check(session.prefill_stats["calls"] == 1, "one packed admission")
    trace_summary("one packed admission (8 x 128 tokens) + 8 decode steps",
                  prof, wall, top_host=10, top_dev=8)


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
        for line in log_path.read_text().splitlines():
            if "registers" in line or "==" in line or "spill" in line:
                log("  " + line.strip())

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
    log(f"command time so far: {time.perf_counter() - t_start:.1f} s")
    if (FAILED or fem is None or serve is None or sharded is None
            or len(rows) < len(REPLACES)):
        log(f"FAILED phases: {FAILED}")
        return 1
    # each path's launches, counted from 0 over its own run
    launches = {**{k: fem[2][k] for k in FEM_KERNELS},
                "prefix_scan": sharded["launches"]["prefix_scan"],
                "serve_prefill": serve["packed"][1]["serve_prefill"],
                "flash_attention": serve["full"][1]["flash_attention"]}
    table = [dict(name=name, route="cuda", source=SRC + SOURCES.get(name, name + ".cu"),
                  replaces=REPLACES[name], launches=launches[name],
                  max_abs_err=rows[name]["max_abs_err"], ms=rows[name]["ms"],
                  plain_ms=rows[name]["plain_ms"],
                  bound_ms=rows[name]["bound_ms"],
                  bound_by=rows[name]["bound_by"],
                  library_ms=rows[name]["library_ms"])
             for name in REPLACES]
    log(json.dumps({"kernels": table}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
