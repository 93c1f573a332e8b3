"""Wrapper of the hand-written SFC-key kernel (``csrc/sfc_keys.cu``).

Replaces the TPU kernel ``repro/kernels/sfc_keys.py::sfc_keys_pallas``.
Its plain version is ``kernels.ref.morton_keys_ref`` / ``hilbert_keys_ref``
(the encoders of ``core.sfc``); ``kernels.ops.sfc_keys_op`` chooses.
"""
from __future__ import annotations

import torch

from . import build

CURVES = {"morton": 0, "hilbert": 1}


def sfc_keys_cuda(grid: torch.Tensor, *, curve: str = "hilbert",
                  bits: int = 10) -> torch.Tensor:
    """(n, 3) int32 grid coordinates on a CUDA device -> (n,) int32 keys.

    Coordinates must lie in ``[0, 2^bits)``; ``bits <= 10`` (30-bit
    keys).  Adds one to ``sfc_keys_cuda.launches`` per launch."""
    if not grid.is_cuda:
        raise ValueError(f"sfc_keys_cuda needs a CUDA tensor, got {grid.device}")
    if (grid.dtype != torch.int32 or grid.dim() != 2 or grid.shape[1] != 3
            or not grid.is_contiguous()):
        raise ValueError("sfc_keys_cuda needs a contiguous (n, 3) int32 grid, "
                         f"got {tuple(grid.shape)} {grid.dtype}")
    if curve not in CURVES:
        raise ValueError(f"unknown curve {curve!r}; choose from {tuple(CURVES)}")
    if not 1 <= bits <= 10:
        raise ValueError(f"bits must be in [1, 10], got {bits}")
    n = grid.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=grid.device)
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(grid.device):
        err = lib.repro_sfc_keys(grid.data_ptr(), out.data_ptr(), n,
                                 CURVES[curve], bits,
                                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "sfc_keys")
    sfc_keys_cuda.launches += 1
    return out


sfc_keys_cuda.launches = 0
