"""Submesh -> process mapping (paper section 2.4, Oliker--Biswas).

The similarity matrix S[i, j] is the weight on old part i that the new
partition puts in part j; the greedy heuristic (repeatedly take the
largest remaining entry) maximises the retained weight within a factor 2
of optimal.  Counterpart of ``repro.core.remap``: the on-device loop
(``greedy_map_torch``, the counterpart of ``greedy_map_jnp``) the
balancer runs, and the host-side numpy loop (``greedy_map``, the control
plane's "master gathers S, broadcasts the map") that ``remap`` runs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..segment import segment_sum_any_order


def similarity_matrix(old_parts: torch.Tensor, new_parts: torch.Tensor,
                      weights: torch.Tensor, p_old: int, p_new: int, *,
                      use_pallas: Optional[bool] = None) -> torch.Tensor:
    """S[i, j] = total weight of items moving old part i -> new part j.

    Items whose old part is out of range (the balancer's pad part
    ``p_old``) land outside the ``p_old * p_new`` segments and are
    dropped.  ``use_pallas``: ``segment_sum_any_order``'s."""
    fused = old_parts.long() * p_new + new_parts.long()
    flat = segment_sum_any_order(weights, fused, p_old * p_new,
                                 use_pallas=use_pallas)
    return flat.reshape(p_old, p_new)


def greedy_map(S) -> np.ndarray:
    """Oliker--Biswas greedy: returns perm[j] = process assigned to new part j.

    Host-side numpy version (control plane).  Handles rectangular S by
    assigning the first min(p_old, p_new) pairs greedily and the remainder
    to unused processes / fresh ids, as the JAX package does."""
    S = np.asarray(S, dtype=np.float64).copy()
    p_old, p_new = S.shape
    perm = np.full(p_new, -1, np.int64)
    used_proc = np.zeros(p_old, bool)
    order = np.argsort(-S, axis=None)  # descending entries
    assigned = 0
    limit = min(p_old, p_new)
    for f in order:
        i, j = divmod(int(f), p_new)
        if perm[j] == -1 and not used_proc[i]:
            perm[j] = i
            used_proc[i] = True
            assigned += 1
            if assigned == limit:
                break
    # leftover parts (p_new > p_old) get fresh process ids round-robin
    free = [i for i in range(max(p_old, p_new))
            if i >= p_old or not used_proc[i]]
    fi = 0
    for j in range(p_new):
        if perm[j] == -1:
            perm[j] = free[fi]
            fi += 1
    return perm


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


def apply_map(new_parts: torch.Tensor, perm) -> torch.Tensor:
    """Relabel new part ids with their assigned process ids."""
    return torch.as_tensor(perm, device=new_parts.device)[new_parts.long()]


def remap(old_parts: torch.Tensor, new_parts: torch.Tensor,
          weights: torch.Tensor, p: int, *, use_host: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Oliker--Biswas step: build S, solve the assignment, relabel.

    ``use_host`` solves it with the numpy ``greedy_map``, else with
    ``greedy_map_torch`` on S's device.  Whichever of {greedy, identity}
    retains more weight is kept, so a remap never increases migration.
    Returns (relabelled new parts, perm), perm int64 on the parts'
    device."""
    S = similarity_matrix(old_parts, new_parts, weights, p, p)
    if use_host:
        perm = torch.as_tensor(greedy_map(S.cpu().numpy()),
                               device=new_parts.device)
    else:
        perm = greedy_map_torch(S)
    Sh = S.cpu().numpy()
    retained_greedy = Sh[perm.cpu().numpy(), np.arange(p)].sum()
    if np.trace(Sh) > retained_greedy:
        perm = torch.arange(p, device=new_parts.device)
    return apply_map(new_parts, perm), perm
