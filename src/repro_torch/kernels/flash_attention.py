"""Wrapper of the hand-written flash-attention kernels: bf16 on Hopper's
wgmma (``csrc/flash_attention_wgmma.cu`` on ``csrc/attention_wgmma.cuh``:
one TMA producer warp keeps a ring of K/V tiles full, consumer
warpgroups of 64 query rows run Q K^T and P V on wgmma and the online
softmax in registers, two of them sharing each K/V tile on long
prompts), float32 on CUDA cores
(``csrc/flash_attention.cu``).

Replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.  Its plain
version is ``kernels.ref.mha_ref``; ``kernels.ops.flash_attention_op``
chooses.  ``attention_plan`` is the bf16 kernels' launch plan (the head
dim they read, the query rows a CTA takes, the key tile, the ring and
the shared memory), in Python so that the CPU tests read it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from . import build

#: the input types the kernels take
DTYPES = (torch.float32, torch.bfloat16)

#: flash_attention_cuda's kernel by input type
#: (``bf16_tensor_core`` is the wgmma kernel)
VARIANTS = {torch.bfloat16: "bf16_tensor_core", torch.float32: "f32_cuda_core"}


#: the largest head dim the flash kernels take (both types)
MAX_HEAD_DIM = 256

#: the bf16 flash kernel's (padded head dim, query rows a CTA) pairs, each
#: with its key tile and ring stages (csrc/flash_attention_wgmma.cu's
#: ``FlashRing``)
TILES = {(64, 64): (64, 4), (128, 64): (64, 2), (128, 128): (64, 4),
         (256, 64): (48, 3)}
#: from this many query rows on, head dims 65..128 take 128 rows a CTA
ROWS_128_FROM = 2048
#: the packed kernel's key tile and ring stages by padded head dim
#: (csrc/serve_prefill.cu's ``PackedRing``: two CTAs an SM)
PACKED_TILES = {64: (64, 4), 128: (64, 2)}
#: the dynamic shared memory a block may use on the H100
SMEM_LIMIT = 232_448


@dataclass(frozen=True)
class AttentionPlan:
    """How the bf16 kernels run one call: ``d_kernel`` is the head dim
    the kernel reads (``d``, or ``dp`` where q, k and v are first copied
    into zero-padded tensors: TMA needs 16-byte row strides and bases);
    ``dp`` the head dim it pads to in shared memory; ``rows`` the query
    rows a CTA takes (64 a consumer warpgroup); ``bk`` / ``stages`` the
    key tile and the depth of the K/V ring; ``smem_bytes`` the dynamic
    shared memory a CTA asks for; ``padded``: q, k and v are copied
    first."""
    d: int
    d_kernel: int
    dp: int
    rows: int
    bk: int
    stages: int
    smem_bytes: int
    padded: bool


def padded_head_dim(d: int) -> int:
    """The kernels' head dim for ``d``: 64, 128 or 256."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be 1..{MAX_HEAD_DIM}, got {d}")
    return next(dp for dp in (64, 128, 256) if d <= dp)


def attention_plan(d: int, s_q: int, *, packed: bool = False,
                   aligned: bool = True, buffer: int = 0) -> AttentionPlan:
    """The bf16 launch plan for head dim ``d`` and ``s_q`` query rows.
    Flash takes 128 query rows a CTA (two consumer warpgroups sharing
    each K/V tile) at padded head dim 128 from ``ROWS_128_FROM`` rows on,
    and 64 (one warpgroup; two or three CTAs an SM below DP = 256)
    otherwise: measured on the card, the shared tiles win on long
    prompts and the extra CTAs below them.  The packed kernel always
    takes 64 (its buffers hold short requests).  ``aligned``: q, k and v
    start at 16-byte aligned addresses; where they do not, or ``d % 8 !=
    0``, the wrapper pads them to ``dp``.  ``buffer``: the packed buffer's length, whose
    key-tile table (12 bytes a tile of 64) joins the shared memory."""
    dp = padded_head_dim(d)
    if packed and dp not in PACKED_TILES:
        raise ValueError(f"the packed kernel takes head dims up to 128, "
                         f"got {d}")
    rows = 128 if not packed and dp == 128 and s_q >= ROWS_128_FROM else 64
    bk, stages = PACKED_TILES[dp] if packed else TILES[dp, rows]
    smem = 1024 + rows * dp * 2 + 2 * stages * bk * dp * 2 \
        + 8 * (2 * stages + 1)
    if packed:
        smem += 12 * -(-buffer // bk)
    padded = d % 8 != 0 or not aligned
    return AttentionPlan(d, dp if padded else d, dp, rows, bk, stages, smem,
                         padded)


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def pad_head_dim(tensors: Sequence[torch.Tensor],
                 d_kernel: int) -> Tuple[torch.Tensor, ...]:
    """Copies of ``tensors`` with the last dim zero-padded to
    ``d_kernel`` (new, hence aligned, storage)."""
    return tuple(torch.nn.functional.pad(t, (0, d_kernel - t.shape[-1]))
                 .contiguous() for t in tensors)


def check_attention_inputs(fn: str, q, k, v, heads_axis: int,
                           max_d: int) -> None:
    """Raise unless q / k / v are contiguous CUDA tensors of one supported
    type on one device, with head dim <= ``max_d`` and query heads a
    multiple of the kv heads (``heads_axis`` is the heads dimension).
    The kernels have no backward pass and autograd cannot see them, so
    inputs that require grad while grad is enabled raise too (before
    anything else): a launch would drop their gradients silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{fn} has no backward pass and its inputs "
                           "require grad: train with use_pallas=False (the "
                           "plain attention), as the reference does")
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
    Returns (b, hq, s, d) in q's dtype.  bf16 runs the wgmma kernel on
    ``attention_plan``, float32 the CUDA-core one (``VARIANTS``).  Adds
    one to ``flash_attention_cuda.launches`` and to its variant's entry of
    ``flash_attention_cuda.variants`` per launch, and to
    ``flash_attention_cuda.padded`` per bf16 launch whose inputs were
    first copied to the plan's padded head dim."""
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
    if q.numel() == 0:
        return torch.empty_like(q)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    hkv = k.shape[1]
    if q.dtype == torch.bfloat16:
        plan = attention_plan(d, s, aligned=aligned16(q, k, v))
        if plan.padded:
            q, k, v = pad_head_dim((q, k, v), plan.d_kernel)
        o = torch.empty_like(q)
        with torch.cuda.device(q.device):
            err = lib.repro_flash_attention_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                hq, hkv, s, s_kv, plan.d_kernel, scale, int(causal),
                window or 0, plan.rows, stream)
        build.check(err, "flash_attention")
        if plan.padded:
            flash_attention_cuda.padded += 1
            o = o[..., :d].contiguous()
    else:
        o = torch.empty_like(q)
        with torch.cuda.device(q.device):
            err = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                hq, hkv, s, s_kv, d, scale, int(causal), window or 0, stream)
        build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variants[VARIANTS[q.dtype]] += 1
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.variants = dict.fromkeys(VARIANTS.values(), 0)
flash_attention_cuda.padded = 0
