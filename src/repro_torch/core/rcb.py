"""Recursive Coordinate Bisection (RCB) -- comparison baseline.

Berger & Bokhari's geometric partitioner: log2(p) rounds; in round r every
current part splits at its weighted median along its longest axis (one
sort per round over all items).  p must be a power of two.  Counterpart
of ``repro.core.rcb``, same float32 arithmetic.
"""
from __future__ import annotations

import torch

from ..segment import segment_sum_any_order


def _segment_extreme(x: torch.Tensor, ids: torch.Tensor, n: int,
                     reduce: str) -> torch.Tensor:
    fill = float("inf") if reduce == "amin" else float("-inf")
    out = torch.full((n,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, ids, x, reduce=reduce, include_self=True)


def rcb_partition(coords: torch.Tensor, weights: torch.Tensor,
                  p: int) -> torch.Tensor:
    """coords (n, 3), weights (n,) -> part ids (n,) int64.  p = 2^k."""
    n = coords.shape[0]
    k = p.bit_length() - 1
    if (1 << k) != p:
        raise ValueError(f"RCB requires p to be a power of two, got {p}")
    xyz = coords.to(torch.float32)
    w = weights.to(torch.float32)
    parts = torch.zeros(n, dtype=torch.int64, device=coords.device)
    for r in range(k):
        nparts = 1 << r
        mins = torch.stack([_segment_extreme(xyz[:, d], parts, nparts, "amin")
                            for d in range(3)], dim=1)
        maxs = torch.stack([_segment_extreme(xyz[:, d], parts, nparts, "amax")
                            for d in range(3)], dim=1)
        axis_per_part = torch.argmax(maxs - mins, dim=1)
        c = torch.gather(xyz, 1, axis_per_part[parts][:, None])[:, 0]
        # order by (part, coordinate), ties by item index: jnp.lexsort
        by_c = torch.argsort(c, stable=True)
        order = by_c[torch.argsort(parts[by_c], stable=True)]
        ps, ws = parts[order], w[order]
        cum = torch.cumsum(ws, dim=0)
        part_tot = segment_sum_any_order(ws, ps, nparts)
        part_start_cum = torch.cat([torch.zeros(1, dtype=torch.float32,
                                                device=coords.device),
                                    torch.cumsum(part_tot, dim=0)])[:-1]
        within = cum - part_start_cum[ps]
        half = 0.5 * part_tot[ps]
        hi_side = within > half + 1e-12
        new_ps = ps * 2 + hi_side.to(torch.int64)
        parts = torch.empty_like(parts)
        parts[order] = new_ps
    return parts
