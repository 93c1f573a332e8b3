"""Wrapper of the hand-written exclusive prefix-sum kernel
(``csrc/prefix_scan.cu``).

Replaces the TPU kernel ``repro/kernels/prefix_scan.py::exclusive_scan_pallas``.
Its plain version is ``kernels.ref.exclusive_scan_ref`` (``torch.cumsum(x)
- x``); ``kernels.ops.exclusive_scan_op`` chooses.
"""
from __future__ import annotations

import torch

from . import build

SCAN_TILE = 4096     # items per block: kTile in csrc/prefix_scan.cu


def exclusive_scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a contiguous (n,) float32 CUDA tensor, any n.

    Deterministic (a fixed order of additions, no atomics); exact on
    integer weights whose total stays below 2^24.  Adds one to
    ``exclusive_scan_cuda.launches`` per launch."""
    if not x.is_cuda:
        raise ValueError(f"exclusive_scan_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("exclusive_scan_cuda needs a contiguous 1-D float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"exclusive_scan_cuda: too many items: {n}")
    scratch = torch.empty(-(-n // SCAN_TILE), dtype=torch.float32,
                          device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.repro_prefix_scan(x.data_ptr(), n, out.data_ptr(),
                                    scratch.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    build.check(err, "prefix_scan")
    exclusive_scan_cuda.launches += 1
    return out


exclusive_scan_cuda.launches = 0
