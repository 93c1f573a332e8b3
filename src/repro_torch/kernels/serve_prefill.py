"""Wrapper of the hand-written packed-prefill attention kernels
(``csrc/serve_prefill.cu``): bf16 on the tensor cores (the body shared
with flash attention, ``csrc/attention_tc.cuh``), float32 on CUDA cores
(``csrc/attention_tile.cuh``).

Replaces the TPU kernel
``repro/kernels/serve_prefill.py::packed_attention_pallas``.  Its plain
version is ``kernels.ref.packed_attention_ref``;
``kernels.ops.packed_attention_op`` chooses.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .flash_attention import DTYPES, VARIANTS, check_attention_inputs


def packed_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          seg: torch.Tensor, *,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Segment-masked causal attention over one packed buffer on a CUDA
    device: q (hq, C, d), k / v (hkv, C, d), float32 or bfloat16,
    contiguous; seg (C,) int32 request ids, -1 = pad.  Key j is visible
    from query i iff ``j <= i`` and ``seg[i] == seg[j] >= 0``; rows that
    see no key are exactly 0.  Returns (hq, C, d) in q's dtype.  bf16
    runs the tensor-core kernel, float32 the CUDA-core one (``VARIANTS``).
    Adds one to ``packed_attention_cuda.launches`` and to its variant's
    entry of ``packed_attention_cuda.variants`` per launch."""
    check_attention_inputs("packed_attention_cuda", q, k, v, heads_axis=0)
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
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.repro_packed_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            o.data_ptr(), hq, k.shape[0], C, d, DTYPES[q.dtype], scale,
            softcap or 0.0, torch.cuda.current_stream().cuda_stream)
    build.check(err, "packed_attention")
    packed_attention_cuda.launches += 1
    packed_attention_cuda.variants[VARIANTS[q.dtype]] += 1
    return o


packed_attention_cuda.launches = 0
packed_attention_cuda.variants = dict.fromkeys(VARIANTS.values(), 0)
