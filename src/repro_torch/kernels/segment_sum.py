"""Wrapper of the hand-written segment-sum kernel (``csrc/segment_sum.cu``).

Replaces no TPU kernel: the JAX package leaves the sum to XLA's
``segment_sum``.  Its plain version is ``index_add_``
(``segment._index_add_sum``); ``segment.segment_sum_any_order`` chooses,
for sums exact in any order (the balancer's).

The route follows the bin count (``route``): bins that fit in a block's
shared memory are kept per block there and added into the output once a
block (``shared``); more bins go straight to the output, one global atomic
an item (``global``).  Each call runs in a tracer span named by its route,
``segment_sum/shared`` or ``segment_sum/global``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import telemetry
from . import build

#: warps a block of the kernel (csrc/segment_sum.cu: kThreads / 32): the
#: most histogram copies the shared route keeps (the C entry refuses more)
WARPS = 16
#: shared-memory bytes a block's copies may take before they are halved:
#: at 64 KB three blocks of 512 threads still fit on an SM
COPY_BUDGET = 64 * 1024
#: opt-in shared memory a block may use, in bytes: sm_90a's, the only
#: target build.py compiles for
SMEM_OPTIN = 232_448


def route(num_segments: int, smem_limit: int = SMEM_OPTIN
          ) -> Tuple[str, int]:
    """``("shared", copies)`` where ``num_segments`` float32 bins fit in
    ``smem_limit`` bytes: one copy a warp, halved while the copies pass
    ``COPY_BUDGET`` (down to one, shared by the block); else
    ``("global", 0)``."""
    need = 4 * num_segments
    if need > smem_limit:
        return "global", 0
    copies = WARPS
    while copies > 1 and copies * need > COPY_BUDGET:
        copies //= 2
    return "shared", copies


def segment_sum_cuda(data: torch.Tensor, ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """(num_segments,) float32 sums of ``data`` by ``ids``, in any order.

    ``data``: contiguous (n,) float32; ``ids``: contiguous (n,) int32 or
    int64, on the same CUDA device.  Ids outside ``[0, num_segments)`` add
    nothing.  The order of additions changes from call to call, so the
    bits are fixed only where every order gives them: integer weights
    whose bin totals stay below 2^24 (then equal to ``index_add_``'s).
    Adds one to ``segment_sum_cuda.launches`` a call that launches."""
    for name, t, types in (("data", data, (torch.float32,)),
                           ("ids", ids, (torch.int32, torch.int64))):
        if t.dtype not in types or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"segment_sum_cuda: {name} must be a contiguous "
                             f"1-D tensor of {[str(d) for d in types]}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if data.shape != ids.shape:
        raise ValueError(f"data {tuple(data.shape)} and ids "
                         f"{tuple(ids.shape)} differ in length")
    if not (data.is_cuda and ids.is_cuda):
        raise ValueError(f"segment_sum_cuda needs CUDA tensors; data is on "
                         f"{data.device}, ids on {ids.device}")
    if data.device != ids.device:
        raise ValueError("data and ids must be on one device")
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments out of range: {num_segments}")
    n = data.shape[0]
    if n == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=torch.float32,
                           device=data.device)
    kind, copies = route(num_segments)
    lib = build.library()
    with telemetry.span(f"segment_sum/{kind}"):
        out = torch.zeros(num_segments, dtype=torch.float32,
                          device=data.device)
        with torch.cuda.device(data.device):
            err = lib.repro_segment_sum(
                data.data_ptr(), ids.data_ptr(), ids.element_size(), n,
                num_segments, copies, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    build.check(err, "segment_sum")
    segment_sum_cuda.launches += 1
    return out


segment_sum_cuda.launches = 0
