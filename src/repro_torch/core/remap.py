"""Submesh -> process mapping (paper section 2.4, Oliker--Biswas).

The similarity matrix S[i, j] is the weight on old part i that the new
partition puts in part j; the greedy heuristic (repeatedly take the
largest remaining entry) maximises the retained weight within a factor 2
of optimal.  Counterpart of ``repro.core.remap``: the on-device loop
(``greedy_map_torch``, the counterpart of ``greedy_map_jnp``) the
balancer runs.
"""
from __future__ import annotations

import torch

from ..segment import segment_sum_any_order


def similarity_matrix(old_parts: torch.Tensor, new_parts: torch.Tensor,
                      weights: torch.Tensor, p_old: int, p_new: int
                      ) -> torch.Tensor:
    """S[i, j] = total weight of items moving old part i -> new part j.

    Items whose old part is out of range (the balancer's pad part
    ``p_old``) land outside the ``p_old * p_new`` segments and are
    dropped."""
    fused = old_parts.long() * p_new + new_parts.long()
    flat = segment_sum_any_order(weights, fused, p_old * p_new)
    return flat.reshape(p_old, p_new)


def greedy_map_torch(S: torch.Tensor) -> torch.Tensor:
    """Greedy assignment for square S (p x p) on S's device: p rounds of
    argmax over the masked matrix (ties go to the first index), no host
    synchronisation."""
    p = S.shape[0]
    if S.shape[1] != p:
        raise ValueError(f"greedy_map_torch needs a square S, got {tuple(S.shape)}")
    Sm = S.to(torch.float32).clone()
    perm = torch.full((p,), -1, dtype=torch.int64, device=S.device)
    for _ in range(p):
        f = torch.argmax(Sm).view(1)
        i, j = f // p, f % p
        perm.index_put_((j,), i)
        Sm.index_fill_(0, i, float("-inf"))
        Sm.index_fill_(1, j, float("-inf"))
    return perm


def guarded_greedy_perm(S: torch.Tensor) -> torch.Tensor:
    """Greedy assignment with the identity guard: keep whichever of
    {greedy, no relabel} retains more weight, so a remap never increases
    migration."""
    p = S.shape[0]
    perm = greedy_map_torch(S)
    ar = torch.arange(p, device=S.device)
    retained_greedy = S[perm, ar].sum()
    return torch.where(torch.trace(S) > retained_greedy, ar, perm)
