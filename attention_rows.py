"""Time the bf16 attention kernels at the shapes of PERF.md's kernel-table
rows 5-6c on the card, beside SDPA and the bound, and optionally beside an
earlier tree's kernels.

    python3 attention_rows.py [--against DIR]

Each row's inputs are random bf16 tensors made from a seed on the card.
The port's kernel runs through its wrapper (``flash_attention_cuda`` /
``packed_attention_cuda``), is held against the plain version within one
bf16 step (``chip_smoke.attention_err``) and must run unpadded; SDPA
(``torch.nn.functional.scaled_dot_product_attention``, a boolean mask for
a window or a packed buffer) is timed as the yardstick only.  With
``--against DIR``, DIR holds an earlier tree (``DIR/src/repro_torch/
kernels/csrc``) whose bf16 kernels have the C entries
``repro_flash_attention_tc`` and ``repro_packed_attention`` (with a dtype
argument); they are built with nvcc into ``DIR/libattention.so``, loaded
with ctypes and timed on the same inputs, in turns with the port's
(earlier, port, port, earlier), and their outputs compared with the
port's.  Times are device ms (``chip_smoke.timed_ms``); one JSON line a
row goes to ``chiprun_out/attention_rows.jsonl``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402

# (row, kind, b, hq, hkv, s_q, s_kv, d, causal, window, packed requests,
#  soft cap)
SEVEN = (128,) * 7
ROWS = [
    ("5 llama s=128", "flash", 1, 32, 8, 128, 128, 128, True, None),
    ("5 llama s=1024", "flash", 1, 32, 8, 1024, 1024, 128, True, None),
    ("5b danube3", "flash", 1, 32, 8, 6144, 6144, 120, True, 4096),
    ("5c danube-1.8b", "flash", 1, 32, 8, 1024, 1024, 80, True, 4096),
    ("5c command-r", "flash", 1, 96, 8, 1024, 1024, 128, True, None),
    ("5d recurrentgemma", "flash", 1, 10, 1, 6144, 6144, 256, True, 2048),
    ("5e whisper encoder", "flash", 16, 16, 16, 1500, 1500, 64, False,
     None),
    ("5f cross prefill", "flash", 16, 16, 16, 128, 1500, 64, False, None),
    ("5f cross decode", "flash", 16, 16, 16, 1, 1500, 64, False, None),
    ("5g qwen2-vl s=128", "flash", 1, 64, 8, 128, 128, 128, True, None),
    ("5g qwen2-vl s=1024", "flash", 1, 64, 8, 1024, 1024, 128, True, None),
    ("5h prefill_32k", "flash", 2, 2, 2, 32768, 32768, 128, True, None),
    ("6 llama 7x128", "packed", 32, 8, 128, SEVEN, None),
    ("6 llama full", "packed", 32, 8, 128, (1024, 512, 256, 128, 128),
     None),
    ("6b danube-1.8b", "packed", 32, 8, 80, SEVEN, None),
    ("6b command-r", "packed", 96, 8, 128, SEVEN, None),
    ("6c grok", "packed", 48, 8, 128, SEVEN, 30.0),
]
C = 2048           # the packed buffer


def build_earlier(tree):
    """The earlier tree's bf16 attention kernels as one ctypes library."""
    csrc = os.path.join(tree, "src", "repro_torch", "kernels", "csrc")
    out = os.path.join(tree, "libattention.so")
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
           "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
           "-fPIC", "-shared", os.path.join(csrc, "flash_attention_tc.cu"),
           os.path.join(csrc, "serve_prefill.cu"), "-o", out]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_attention_tc.argtypes = [p, p, p, p, i, i, i, i, i, i, f,
                                             i, i, p]
    lib.repro_packed_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f,
                                           p]
    return lib


def flash_row(row, earlier, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.dryrun import flash_pairs
    from repro_torch.models.layers import _blocked_causal_attention
    label, _, b, hq, hkv, s, s_kv, d, causal, window = row
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, hkv, s_kv, d), generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn((b, hkv, s_kv, d), generator=gen,
                    device="cuda").bfloat16()
    padded = flash_attention_cuda.padded
    port = lambda: flash_attention_cuda(q, k, v, causal=causal,  # noqa: E731
                                        window=window)
    got = port()
    chip_smoke.check(flash_attention_cuda.padded == padded,
                     f"{label}: the inputs were padded")
    if s * s_kv * hq * b > 2 ** 31:      # the plain blocked attention
        g = hq // hkv
        want = _blocked_causal_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            window=window, chunk=1024)
    else:
        want = ref.mha_ref(q, k, v, causal=causal, window=window)
    err, _ = chip_smoke.attention_err(label, got, want)
    del want
    if window is not None:
        i = torch.arange(s, device="cuda")
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=band, enable_gqa=True)
    else:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    pairs = flash_pairs(s, s_kv, causal, window)
    bound, by = chip_smoke.attention_bound(b * hq * pairs, hq, hkv, b * s,
                                           b * s, d, n_kv=b * s_kv)
    old = None
    if earlier is not None:
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        old = lambda: earlier.repro_flash_attention_tc(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            hkv, s, s_kv, d, 1.0 / math.sqrt(d), int(causal), window or 0,
            stream)
        chip_smoke.check(old() == 0, f"{label}: the earlier kernel refused")
        torch.cuda.synchronize()
        old_diff = float((o.float() - got.float()).abs().max())
    return port, old, sdpa, bound, by, err, (old_diff if old else None)


def packed_row(row, earlier, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.serve_prefill import packed_attention_cuda
    label, _, hq, hkv, d, lengths, cap = row
    q = torch.randn((hq, C, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((hkv, C, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((hkv, C, d), generator=gen, device="cuda").bfloat16()
    seg_np = chip_smoke.full_buffer_seg(C, lengths)
    seg = torch.as_tensor(seg_np, device="cuda")
    padded = packed_attention_cuda.padded
    port = lambda: packed_attention_cuda(q, k, v, seg,  # noqa: E731
                                         softcap=cap)
    got = port()
    chip_smoke.check(packed_attention_cuda.padded == padded,
                     f"{label}: the inputs were padded")
    chip_smoke.check(bool((got[:, seg < 0] == 0).all()),
                     f"{label}: pad rows not 0")
    err, _ = chip_smoke.attention_err(
        label, got, ref.packed_attention_ref(q, k, v, seg, softcap=cap))
    real = seg >= 0
    i = torch.arange(C, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (seg[:, None] == seg[None, :]) \
        & real[:, None]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], attn_mask=mask, enable_gqa=True)
    pairs = hq * sum(n * (n + 1) // 2 for n in lengths)
    bound, by = chip_smoke.attention_bound(pairs, hq, hkv, int(real.sum()),
                                           C, d, extra_bytes=4 * C)
    old = None
    if earlier is not None:
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        old = lambda: earlier.repro_packed_attention(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            o.data_ptr(), hq, hkv, C, d, 1, 1.0 / math.sqrt(d), cap or 0.0,
            stream)
        chip_smoke.check(old() == 0, f"{label}: the earlier kernel refused")
        torch.cuda.synchronize()
        old_diff = float((o.float() - got.float()).abs().max())
    return port, old, sdpa, bound, by, err, (old_diff if old else None)


def warm_up(gen, seconds=3.0):
    """Keep the card busy for a few seconds first, so that the first
    rows are not timed while its clocks ramp up."""
    import time
    import torch
    a = torch.randn((8192, 8192), generator=gen, device="cuda").bfloat16()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="an earlier tree to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_rows: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.nvidia_smi_line()
    print(f"card: {card}", flush=True)
    earlier = build_earlier(args.against) if args.against else None
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = open(os.path.join(ROOT, "chiprun_out", "attention_rows.jsonl"),
               "w")
    gen = torch.Generator(device="cuda").manual_seed(27)
    warm_up(gen)
    for row in ROWS:
        fn = flash_row if row[1] == "flash" else packed_row
        port, old, sdpa, bound, by, err, old_diff = fn(row, earlier, gen)
        times = {"port": [], "earlier": []}
        order = ("earlier", "port", "port", "earlier") if old else ("port",)
        for who in order:
            times[who].append(chip_smoke.timed_ms(
                port if who == "port" else old, reps=10)[0])
        ms = sum(times["port"]) / len(times["port"])
        old_ms = (sum(times["earlier"]) / len(times["earlier"])
                  if old else None)
        sdpa_ms = chip_smoke.timed_ms(sdpa, reps=10)[0]
        rec = dict(row=row[0], ms=ms, earlier_ms=old_ms, sdpa_ms=sdpa_ms,
                   bound_ms=bound, bound_by=by, share=bound / ms,
                   max_abs_err=err, earlier_max_diff=old_diff,
                   times=times, card=card)
        print(json.dumps(rec), flush=True)
        out.write(json.dumps(rec) + "\n")
        torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
