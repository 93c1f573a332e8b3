"""Data-migration executor (paper section 2.5): every item whose new part
differs from its owner moves there.

PHG does this with ``MPI_Alltoallv``; as in the JAX package, the exchange
here has a fixed capacity so every shape is known in advance:

1. each rank buckets its local items by destination and packs them into
   a dense ``(p*C, ...)`` send buffer per payload leaf (slot = stable rank
   within the destination group, from one stable argsort);
2. one ``all_to_all`` per leaf exchanges the buffers;
3. the receiver compacts the valid items to the front of its ``(p*C,
   ...)`` receive window (a stable argsort on the validity mask, so
   arrival order is source-rank-major).

A rank can receive at most ``p*C`` items, so the default window never
overflows; a caller that knows a tighter bound passes ``capacity``, and
the items that did not fit are counted in ``overflow``, never silently
lost.  Counterpart of ``repro.distributed.migrate``; a payload is a dict
of ``(C, ...)`` tensors (the JAX package's pytree).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class MigrationResult(NamedTuple):
    payload: Dict[str, torch.Tensor]  # leaves (R, ...) received items, padded
    weights: torch.Tensor     # (R,) received item weights (0 on padding)
    valid: torch.Tensor       # (R,) bool
    n_recv: torch.Tensor      # () int64 valid received items
    overflow: torch.Tensor    # () int64 items dropped by a tight `capacity`
    w_sent: torch.Tensor      # () f32 weight shipped to other ranks
    w_received: torch.Tensor  # () f32 weight arriving from other ranks
    w_kept: torch.Tensor      # () f32 weight that stayed local


def payload_nbytes(payload: Dict[str, object]) -> int:
    """Wire bytes of ONE item of a ``(C, ...)``-leaf payload: the sum of
    ``prod(shape[1:]) * itemsize`` over the leaves.  Leaves may be tensors
    or anything with ``shape`` and a numpy / torch ``dtype``."""
    def nb(leaf) -> int:
        dt = leaf.dtype
        size = (dt.itemsize if isinstance(dt, torch.dtype)
                else np.dtype(dt).itemsize)
        return int(np.prod(tuple(leaf.shape[1:]), dtype=np.int64)) * size
    return sum(nb(leaf) for leaf in payload.values())


def dispatch_slots(dest: torch.Tensor, valid: torch.Tensor,
                   p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable slot of each item within its destination group.

    Invalid items are parked in bucket ``p`` so they never collide with a
    real destination.  One stable argsort + searchsorted.  Returns
    ``(slot, parked_dest)``."""
    C = dest.shape[0]
    d = torch.where(valid, dest.long(), torch.full_like(dest.long(), p))
    order = torch.argsort(d, stable=True)
    sd = d[order].contiguous()
    first = torch.searchsorted(sd, sd, right=False)
    slot = torch.empty(C, dtype=torch.int64, device=dest.device)
    slot[order] = torch.arange(C, device=dest.device) - first
    return slot, d


def migrate_items(payload: Dict[str, torch.Tensor], dest: torch.Tensor,
                  weights: torch.Tensor, comm, p: int, *,
                  valid: Optional[torch.Tensor] = None,
                  capacity: Optional[int] = None) -> MigrationResult:
    """Move this rank's items to their destination ranks.

    payload   dict of (C, ...) tensors riding along with each item
    dest      (C,) destination rank per item
    weights   (C,) weight per item (drives the volume metrics)
    valid     (C,) bool mask of real (non-padding) items
    capacity  receive-window size; default p*C (never drops)

    Every rank calls it with the same C, leaves and ``capacity``."""
    C = dest.shape[0]
    dev = dest.device
    if valid is None:
        valid = torch.ones(C, dtype=torch.bool, device=dev)
    rank = comm.rank
    w = torch.where(valid, weights.to(torch.float32), 0.0)

    slot, d = dispatch_slots(dest, valid, p)
    flat = d * C + slot                      # parked items land >= p*C
    keep = flat < p * C                      # the reference's mode="drop"

    def scatter(leaf: torch.Tensor) -> torch.Tensor:
        buf = leaf.new_zeros((p * C,) + tuple(leaf.shape[1:]))
        buf[flat[keep]] = leaf[keep]
        return buf

    names = list(payload)
    sent = [scatter(payload[k]) for k in names]
    sent += [scatter(w), scatter(valid.to(torch.int32))]
    recv = [comm.all_to_all(s) for s in sent]
    recv_w = recv[-2]
    recv_valid = recv[-1].bool()             # (p*C,), block = source rank

    # volume bookkeeping before compaction loses the source blocks
    w_sent = torch.where(d != rank, w, 0.0).sum()
    per_src = torch.where(recv_valid, recv_w, 0.0).reshape(p, C).sum(dim=1)
    w_kept = per_src[rank]
    w_received = per_src.sum() - w_kept

    # compact valid items to the front (stable -> source-major order)
    order = torch.argsort((~recv_valid).to(torch.int8), stable=True)
    R = capacity if capacity is not None else p * C

    def compact(leaf: torch.Tensor) -> torch.Tensor:
        return leaf[order][:R]

    out_payload = {k: compact(v) for k, v in zip(names, recv[:-2])}
    out_valid = recv_valid[order][:R]
    out_w = torch.where(out_valid, compact(recv_w), 0.0)
    n_total = recv_valid.sum()
    n_recv = torch.clamp(n_total, max=R)
    return MigrationResult(out_payload, out_w, out_valid, n_recv,
                           n_total - n_recv, w_sent, w_received, w_kept)
