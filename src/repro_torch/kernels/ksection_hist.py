"""Wrapper of the hand-written k-section histogram kernel
(``csrc/ksection_hist.cu``).

Replaces the TPU kernel
``repro/kernels/ksection_hist.py::ksection_histogram_pallas``.  Its plain
version is ``kernels.ref.ksection_histogram_ref`` (``core.partition1d
.weight_below``: searchsorted + ``index_add_`` + cumsum);
``kernels.ops.ksection_histogram_op`` chooses.
"""
from __future__ import annotations

import torch

from . import build

KS_TILE = 1024       # items per tile: kTile in csrc/ksection_hist.cu
BLOCKS_PER_SM = 8    # resident blocks asked for per SM (tiles are strided)


def ksection_hist_cuda(keys: torch.Tensor, weights: torch.Tensor,
                       cuts: torch.Tensor) -> torch.Tensor:
    """Weight strictly below each of the (m,) cuts, in any order.

    ``keys`` / ``weights``: (n,) float32, ``cuts``: (m,) float32, all
    contiguous on one CUDA device.  Returns (m,) float32.  Deterministic
    (a fixed-order reduction over per-block partials, no atomics).  Adds
    one to ``ksection_hist_cuda.launches`` per launch."""
    for name, t in (("keys", keys), ("weights", weights), ("cuts", cuts)):
        if not t.is_cuda:
            raise ValueError(f"ksection_hist_cuda needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"ksection_hist_cuda: {name} must be a contiguous "
                             f"1-D float32 tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if keys.shape != weights.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and weights "
                         f"{tuple(weights.shape)} differ in length")
    if not keys.device == weights.device == cuts.device:
        raise ValueError("keys, weights and cuts must be on one device")
    n, m = keys.shape[0], cuts.shape[0]
    if n == 0 or m == 0:
        return torch.zeros(m, dtype=torch.float32, device=cuts.device)
    if m >= 2 ** 31:
        raise ValueError(f"too many cuts: {m}")
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    n_blocks = min(-(-n // KS_TILE), BLOCKS_PER_SM * sms)
    partials = torch.empty(n_blocks * m, dtype=torch.float32,
                           device=keys.device)
    out = torch.empty(m, dtype=torch.float32, device=keys.device)
    lib = build.library()
    with torch.cuda.device(keys.device):
        err = lib.repro_ksection_hist(
            keys.data_ptr(), weights.data_ptr(), n, cuts.data_ptr(), m,
            partials.data_ptr(), n_blocks, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "ksection_hist")
    ksection_hist_cuda.launches += 1
    return out


ksection_hist_cuda.launches = 0
