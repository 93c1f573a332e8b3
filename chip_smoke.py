#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  It

1. prints the card and builds the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` (into ``build/kernels``);
2. drives the main path -- an adaptive Helmholtz session (paper Example
   3.1) from 786,432 tets with incremental k-section balancing on 64
   parts -- and checks that every kernel was launched during it; its
   first two steps run under torch.profiler, whose summary gives the
   device's idle share and where the host time goes; then replays each
   step of a smoke-size session on the CPU from the card's mesh;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the session, timing both by the device time torch.profiler
   records (and, with host dispatch, by CUDA events);
4. replays the last balance with the kernels and with the plain versions
   (every field equal);
5. runs the standalone DLB step at scale: 8M points, p = 1024, hsfc and
   msfc x sorted and k-section, kernels against plain versions;
6. prints the kernel table as one JSON line, the card's name and power
   limit, and ``{"ok": true, ...}`` as the last line.

Any failed check raises, and the script exits non-zero without the last
line.  Without CUDA it exits 2 before doing anything.
"""
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

    Device ms sums the durations of the device events that torch.profiler
    records over ``reps`` calls, so host dispatch drops out.  Call ms is
    CUDA events around ``reps`` back-to-back calls: it includes host
    dispatch wherever that outlasts the device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    check(events, "torch.profiler recorded no device activity")
    dev_us = sum(e.time_range.elapsed_us() for e in events)
    return dev_us / 1e3 / reps, call_ms


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
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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
    """The session with kernels on the card against the plain versions on
    the CPU at the quickstart's smoke size (which the CPU tests hold
    against the JAX package), step by step on the card's own meshes.

    Dörfler marking sorts float32 indicators, and the cylinder mesh has
    many equal ones.  The card's atomic sums change their last bits from
    run to run, so the card can mark another of several tied elements
    than the CPU does, after which two whole sessions refine different
    meshes.  So each step the card ran is replayed on the CPU, as a
    one-step session from a copy of the mesh that step solved on, and
    held to it: cg iterations within 2, err_l2 and total eta within
    SMALL_RTOL, and the same marked set up to ties (an element marked on
    one side only has the smallest marked indicator, within TIE_RTOL)."""
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

    AdaptiveSession(spec, device=dev, on_step=keep(card, solved_on)).run(mesh)
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


def compare_matvec(mesh, dev):
    import numpy as np
    import torch
    from repro_torch.fem import build_elements
    from repro_torch.kernels import ref
    from repro_torch.kernels.fem_matvec import (fem_element_matrices,
                                                fem_matvec_cuda)
    el = build_elements(mesh.verts, mesh.tets, device=dev)
    kel = fem_element_matrices(el.grads, el.vol, 1.0).contiguous()
    tets = el.tets.contiguous()
    C, V = tets.shape[0], el.n_verts
    g = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand(V, generator=g, device=dev, dtype=torch.float32)
    got = fem_matvec_cuda(tets, kel, u, V)
    want = ref.fem_matvec_kel_ref(tets, kel, u, V)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= 1e-5 * scale, f"fem_matvec: max err {err} > 1e-5 * {scale}")
    ms, call_ms = timed_ms(lambda: fem_matvec_cuda(tets, kel, u, V))
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
    log(f"fem_matvec C={C} V={V}: kernel_ms={ms:.4f} (call {call_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} (call {plain_call_ms:.4f}) csr_spmv_ms="
        f"{lib_ms:.4f} (call {lib_call_ms:.4f}) bound_ms={bound:.4f} "
        f"max_abs_err={err:.3e} "
        f"(tolerance 1e-5 * max|y| = {1e-5 * scale:.3e}; csr err {lib_err:.3e})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=lib_ms, max_abs_err=err)


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

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import build, ops

    dev = "cuda"
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

    res, session, counts, balanced = run_session(dev)
    small_session_agreement(dev)

    # keys and histogram at the shapes of the session's last repartition,
    # the matvec at its last solve's
    log(f"kernel shapes: keys and histogram from step {balanced['step']} "
        f"(n={len(balanced['coords'])}), matvec from the last mesh")
    rows = {}
    rows["sfc_keys"], coords, lo, hi = compare_sfc(balanced["coords"], dev)
    from repro_torch.core.sfc import sfc_keys
    keys = sfc_keys(coords, lo, hi).to(torch.float32)
    kf, wf = pad_pow2(keys, torch.ones_like(keys))
    rows["ksection_hist"] = compare_hist(kf.contiguous(), wf.contiguous(),
                                         64, "p=64")
    compare_hist(kf.contiguous(), wf.contiguous(), 1024, "p=1024")
    rows["fem_matvec"] = compare_matvec(res.mesh, dev)
    replay_balance(res, session, dev)
    standalone_dlb(dev)

    src = "src/repro_torch/kernels/csrc/"
    replaces = {"sfc_keys": "src/repro/kernels/sfc_keys.py:88",
                "ksection_hist": "src/repro/kernels/ksection_hist.py:95",
                "fem_matvec": "src/repro/kernels/fem_matvec.py:108"}
    table = [dict(name=name, route="cuda", source=src + name + ".cu",
                  replaces=replaces[name], launches=counts[name],
                  max_abs_err=rows[name]["max_abs_err"], ms=rows[name]["ms"],
                  plain_ms=rows[name]["plain_ms"],
                  bound_ms=rows[name]["bound_ms"],
                  bound_by=rows[name]["bound_by"],
                  library_ms=rows[name]["library_ms"])
             for name in ("sfc_keys", "ksection_hist", "fem_matvec")]
    log(json.dumps({"kernels": table}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
