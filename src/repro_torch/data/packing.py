"""Sequence packing for the serving engine's packed prefill.

``first_fit_pack`` is copied from ``repro/data/packing.py``; the rest of
that module (the balanced training-data packer, the synthetic corpus)
waits with the training slice (ROADMAP.md, queue 1, items 10 and 12).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def first_fit_pack(lengths: np.ndarray, capacity: int, *, align: int = 1,
                   max_items: Optional[int] = None
                   ) -> Tuple[List[int], List[int], int]:
    """First-fit one fixed-capacity buffer; never splits an item.

    Scan ``lengths`` in order and admit every item whose ``align``-rounded
    length still fits in the remaining capacity (skipped items do NOT
    block later smaller ones -- first-fit, not first-blocked).  Items
    start at ``align`` boundaries; the serving engine uses KV-page
    alignment so every packed request's pages map to exactly one slot.

    Returns ``(chosen, offsets, used)``: indices into ``lengths`` of the
    admitted items, their start offsets in the buffer, and total tokens
    consumed (<= capacity, an ``align`` multiple when all offsets are).
    """
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    chosen: List[int] = []
    offsets: List[int] = []
    used = 0
    for i, ln in enumerate(np.asarray(lengths, np.int64)):
        ln = int(ln)
        if ln < 1:
            raise ValueError(f"item {i} has non-positive length {ln}")
        padded = -(-ln // align) * align
        if used + padded > capacity:
            continue
        if max_items is not None and len(chosen) >= max_items:
            break
        chosen.append(i)
        offsets.append(used)
        used += padded
    return chosen, offsets, used
