"""Wrapper of the hand-written exclusive prefix-sum kernel
(``csrc/prefix_scan.cu``).

Replaces the TPU kernel ``repro/kernels/prefix_scan.py::exclusive_scan_pallas``.
Its plain version is ``kernels.ref.exclusive_scan_ref`` (``torch.cumsum(x)
- x``); ``kernels.ops.exclusive_scan_op`` chooses.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import build

#: items in the smallest tile of csrc/prefix_scan.cu; sizes the status buffer
SCAN_TILE = 4096
_MIN_STATUS_WORDS = 1024
_LAST_EPOCH = (1 << 32) - 1

#: (device index, raw stream) -> [status words (int64), last epoch]: the
#: kernel's ticket and per-tile flags, one buffer per stream, since calls
#: on one stream run in order and each passes a new epoch
_status: Dict[Tuple[int, int], List] = {}


def _status_for(device: torch.device, stream: int,
                tiles: int) -> Tuple[torch.Tensor, int]:
    """The stream's status buffer (zeroed when made or grown) and the
    epoch of this call."""
    entry = _status.get((device.index, stream))
    if (entry is None or entry[0].numel() < tiles + 1
            or entry[1] == _LAST_EPOCH):
        words = max(_MIN_STATUS_WORDS, 1 << tiles.bit_length())
        # made on the current stream, which is the kernel's
        entry = [torch.zeros(words, dtype=torch.int64, device=device), 0]
        _status[(device.index, stream)] = entry
    entry[1] += 1
    return entry[0], entry[1]


def exclusive_scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a contiguous (n,) float32 CUDA tensor, any n.

    One launch; deterministic (an order of additions fixed by n, no
    float atomics); exact on integer weights whose total stays below
    2^24.  Adds one to ``exclusive_scan_cuda.launches`` per launch."""
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
    dev = x.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    status, epoch = _status_for(dev, stream, -(-n // SCAN_TILE))
    lib = build.library()
    args = (x.data_ptr(), n, out.data_ptr(), status.data_ptr(), epoch,
            stream)
    if dev.index == torch.cuda.current_device():
        err = lib.repro_prefix_scan(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.repro_prefix_scan(*args)
    build.check(err, "prefix_scan")
    exclusive_scan_cuda.launches += 1
    return out


exclusive_scan_cuda.launches = 0
