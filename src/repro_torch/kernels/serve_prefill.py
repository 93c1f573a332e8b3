"""Wrapper of the hand-written packed-prefill attention kernels
(``csrc/serve_prefill.cu``): bf16 on Hopper's wgmma (the body shared
with flash attention, ``csrc/attention_wgmma.cuh``: a TMA producer warp
feeding a K/V ring, one consumer warpgroup of 64 query rows a CTA, on
``flash_attention.attention_plan(..., packed=True)``), float32 on CUDA
cores (``csrc/attention_tile.cuh``).

Replaces the TPU kernel
``repro/kernels/serve_prefill.py::packed_attention_pallas``.  Its plain
version is ``kernels.ref.packed_attention_ref``;
``kernels.ops.packed_attention_op`` chooses.  Head dims up to 128
(``MAX_HEAD_DIM``): the packed prefill takes the KV-cache families only,
whose head dims stop at 128; the hybrid family's 256 runs the flash
kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .flash_attention import (VARIANTS, aligned16, attention_plan,
                              check_attention_inputs, pad_head_dim)

#: the largest head dim the packed kernels take
MAX_HEAD_DIM = 128


def packed_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          seg: torch.Tensor, *,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Segment-masked causal attention over one packed buffer on a CUDA
    device: q (hq, C, d), k / v (hkv, C, d), float32 or bfloat16,
    contiguous; seg (C,) int32 request ids, -1 = pad.  Key j is visible
    from query i iff ``j <= i`` and ``seg[i] == seg[j] >= 0``; rows that
    see no key are exactly 0.  Returns (hq, C, d) in q's dtype.  bf16
    runs the wgmma kernel, float32 the CUDA-core one (``VARIANTS``).
    Adds one to ``packed_attention_cuda.launches`` and to its variant's
    entry of ``packed_attention_cuda.variants`` per launch, and to
    ``packed_attention_cuda.padded`` per bf16 launch whose inputs were
    first copied to the plan's padded head dim."""
    check_attention_inputs("packed_attention_cuda", q, k, v, heads_axis=0,
                           max_d=MAX_HEAD_DIM)
    hq, C, d = q.shape
    if k.dim() != 3 or k.shape[1] != C:
        raise ValueError(f"packed_attention_cuda: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if (seg.dtype != torch.int32 or seg.shape != (C,) or not seg.is_cuda
            or not seg.is_contiguous() or seg.device != q.device):
        raise ValueError("packed_attention_cuda: seg must be a contiguous "
                         f"(C,) int32 tensor on {q.device}, got "
                         f"{tuple(seg.shape)} {seg.dtype} on {seg.device}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.numel() == 0:
        return torch.empty_like(q)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    hkv = k.shape[0]
    if q.dtype == torch.bfloat16:
        plan = attention_plan(d, C, packed=True, aligned=aligned16(q, k, v),
                              buffer=C)
        if plan.padded:
            q, k, v = pad_head_dim((q, k, v), plan.d_kernel)
        o = torch.empty_like(q)
        with torch.cuda.device(q.device):
            err = lib.repro_packed_attention_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                o.data_ptr(), hq, hkv, C, plan.d_kernel, scale,
                softcap or 0.0, plan.rows, stream)
        build.check(err, "packed_attention")
        if plan.padded:
            packed_attention_cuda.padded += 1
            o = o[..., :d].contiguous()
    else:
        o = torch.empty_like(q)
        with torch.cuda.device(q.device):
            err = lib.repro_packed_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                o.data_ptr(), hq, hkv, C, d, scale, softcap or 0.0, stream)
        build.check(err, "packed_attention")
    packed_attention_cuda.launches += 1
    packed_attention_cuda.variants[VARIANTS[q.dtype]] += 1
    return o


packed_attention_cuda.launches = 0
packed_attention_cuda.variants = dict.fromkeys(VARIANTS.values(), 0)
packed_attention_cuda.padded = 0
