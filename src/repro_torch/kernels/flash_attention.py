"""Wrapper of the hand-written flash-attention kernels: bf16 on the
tensor cores (``csrc/flash_attention_tc.cu``), float32 on CUDA cores
(``csrc/flash_attention.cu``).

Replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.  Its plain
version is ``kernels.ref.mha_ref``; ``kernels.ops.flash_attention_op``
chooses.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build

#: tensor dtype -> the C entry's dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: flash_attention_cuda's kernel by input type
VARIANTS = {torch.bfloat16: "bf16_tensor_core", torch.float32: "f32_cuda_core"}


#: the largest head dim the flash kernels take (both types)
MAX_HEAD_DIM = 256


def check_attention_inputs(fn: str, q, k, v, heads_axis: int,
                           max_d: int) -> None:
    """Raise unless q / k / v are contiguous CUDA tensors of one supported
    type on one device, with head dim <= ``max_d`` and query heads a
    multiple of the kv heads (``heads_axis`` is the heads dimension)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{fn} needs CUDA tensors; {name} is on "
                             f"{t.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{fn}: q, k and v must share one dtype of "
                             f"{list(DTYPES)}, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if not q.device == k.device == v.device:
        raise ValueError(f"{fn}: q, k and v must be on one device")
    if k.shape != v.shape:
        raise ValueError(f"{fn}: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "differ")
    hq, hkv, d = q.shape[heads_axis], k.shape[heads_axis], q.shape[-1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{fn}: {hq} query heads are not a multiple of "
                         f"{hkv} kv heads")
    if not 1 <= d <= max_d or k.shape[-1] != d:
        raise ValueError(f"{fn}: head dim must be 1..{max_d} and equal in q "
                         f"and k, got {d} and {k.shape[-1]}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention on a CUDA device: q (b, hq, s, d), k / v (b, hkv, s_kv,
    d), float32 or bfloat16, contiguous, d <= 256.  Query head h reads kv
    head ``h // (hq // hkv)``; key j is visible from query i iff ``j <=
    i`` (causal) and ``j > i - window`` (window).  s_kv may differ from s
    only without a mask (``causal=False``, no window): cross-attention.
    Returns (b, hq, s, d) in q's dtype.  bf16 runs the tensor-core kernel,
    float32 the CUDA-core one (``VARIANTS``).  Adds one to
    ``flash_attention_cuda.launches`` and to its variant's entry of
    ``flash_attention_cuda.variants`` per launch."""
    check_attention_inputs("flash_attention_cuda", q, k, v, heads_axis=1,
                           max_d=MAX_HEAD_DIM)
    b, hq, s, d = q.shape
    if k.dim() != 4 or k.shape[0] != b:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    s_kv = k.shape[2]
    if s_kv != s and (causal or window is not None):
        raise ValueError(f"flash_attention_cuda: {s_kv} keys for {s} "
                         "queries (cross-attention) take no causal mask and "
                         "no window")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            k.shape[1], s, s_kv, d, scale, int(causal), window or 0)
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            err = lib.repro_flash_attention_tc(*args, stream)
        else:
            err = lib.repro_flash_attention(*args, stream)
    build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variants[VARIANTS[q.dtype]] += 1
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.variants = dict.fromkeys(VARIANTS.values(), 0)
