"""Segment sum with the JAX package's out-of-range semantics."""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` buckets by ``ids``.

    Ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them (the pad part ``p`` of the balancer,
    the pad slot ``n_out`` of the element matvec).  ``index_add_`` would
    raise on them instead, so they are masked to a zero contribution."""
    ids = ids.reshape(-1).long()
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    if num_segments == 0 or ids.numel() == 0:
        return out
    valid = (ids >= 0) & (ids < num_segments)
    rows = valid.view((-1,) + (1,) * (data.dim() - 1))
    return out.index_add_(0, torch.where(valid, ids, 0),
                          torch.where(rows, data, 0))
