"""Partition-quality and migration metrics used throughout the paper.

* load imbalance          max part weight / mean part weight
* migration volume        TotalV (sum of moved weight) and MaxV (max per
                          process), paper section 2.4
* cut                     element-adjacency links crossing parts
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..segment import segment_sum_any_order


class PartitionQuality(NamedTuple):
    imbalance: torch.Tensor      # max/mean part weight  (1.0 = perfect)
    part_weights: torch.Tensor   # (p,)
    cut: Optional[torch.Tensor]  # crossing links, if adjacency given


def imbalance_of_part_weights(part_weights: torch.Tensor) -> torch.Tensor:
    """max/mean part weight -- the single definition every path uses."""
    return part_weights.max() / torch.clamp(part_weights.mean(), min=1e-30)


def cut_links(parts: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
    """Number of adjacency links crossing parts (communication proxy)."""
    return (parts[adjacency[:, 0]] != parts[adjacency[:, 1]]).sum()


def imbalance(parts: torch.Tensor, weights: torch.Tensor, p: int) -> torch.Tensor:
    return imbalance_of_part_weights(segment_sum_any_order(weights, parts, p))


def quality(parts: torch.Tensor, weights: torch.Tensor, p: int,
            adjacency: Optional[torch.Tensor] = None) -> PartitionQuality:
    """adjacency: (m, 2) pairs of item ids that communicate (shared faces)."""
    pw = segment_sum_any_order(weights, parts, p)
    cut = None if adjacency is None else cut_links(parts, adjacency)
    return PartitionQuality(imbalance_of_part_weights(pw), pw, cut)


def migration_volume(old_parts: torch.Tensor, new_parts: torch.Tensor,
                     weights: torch.Tensor, p: int) -> dict:
    """TotalV / MaxV of moving from old to new assignment."""
    moved = old_parts != new_parts
    moved_w = torch.where(moved, weights, 0.0)
    outgoing = segment_sum_any_order(moved_w, old_parts, p)
    incoming = segment_sum_any_order(moved_w, new_parts, p)
    return {
        "TotalV": moved_w.sum(),
        "MaxV": torch.maximum(outgoing.max(), incoming.max()),
        "retained": torch.where(moved, 0.0, weights).sum(),
    }
