"""Peaks of the card and the least work each measured piece has to do:
the benchmark's own copies, so that the program cannot move them.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit.  Bytes
are counted once per input read and once per output written.
"""
from __future__ import annotations

import math

#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores (the k-section's compares), a second
FP32_OPS_PER_S = 67e12


def sfc_keys_bound_s(n: int) -> float:
    """``sfc_keys``: an int32 (x, y, z) read and an int32 key written,
    16 bytes a key."""
    return 16.0 * n / HBM_BYTES_PER_S


def ksection_hist_bound_s(n: int, m: int) -> float:
    """``ksection_hist``: a float32 key and weight read a item and the m
    cuts read and their sums written (8n + 8m bytes), or one compare per
    level of a binary search among the cuts, whichever takes longer."""
    return max((8.0 * n + 8.0 * m) / HBM_BYTES_PER_S,
               n * math.ceil(math.log2(m + 1)) / FP32_OPS_PER_S)


def repartition_bytes(n: int, has_old: bool) -> float:
    """The least a repartition moves, whatever implements it: the float32
    coordinates (12n) and weights (4n) read once, the int64 old parts
    (8n) read where there are any, the int64 parts (8n) written once."""
    return (12.0 + 4.0 + (8.0 if has_old else 0.0) + 8.0) * n
