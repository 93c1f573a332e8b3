"""Greedy graph-growing partitioner -- stand-in for the paper's ParMETIS.
Counterpart of ``repro/core/graph_greedy.py``, line for line (its BFS
frontier a deque, not a list: the same order, without a list's O(n)
pop from the front), so the same parts from the same inputs.

The paper compares against multilevel graph partitioning (ParMETIS).  A
full multilevel K-way implementation is out of scope; this module
provides the classic greedy graph-growing method (Farhat-style): grow
part 0 from a peripheral seed by BFS until it holds W/p weight, then
part 1 from the boundary, etc.  It exhibits the defining properties the
paper attributes to graph methods -- explicit cut control (good
quality), slower and non-incremental (bad migration) -- so the
experimental comparisons remain meaningful.

Host-side numpy: graph partitioning is control-plane work here, exactly as
PHG delegates it to an external library.
"""
from __future__ import annotations

from collections import deque

import numpy as np


def _csr_from_pairs(n: int, pairs: np.ndarray):
    """Undirected adjacency pairs (m,2) -> CSR (indptr, indices)."""
    u = np.concatenate([pairs[:, 0], pairs[:, 1]])
    v = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, u + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, v


def greedy_graph_partition(n: int, pairs: np.ndarray, weights: np.ndarray,
                           p: int, seed: int = 0) -> np.ndarray:
    """Greedy graph growing.  pairs: (m, 2) adjacency; returns part ids."""
    weights = np.asarray(weights, np.float64)
    indptr, indices = _csr_from_pairs(n, np.asarray(pairs, np.int64))
    total = weights.sum()
    target = total / p
    parts = np.full(n, -1, np.int64)
    unassigned = n

    rng = np.random.default_rng(seed)
    cur_seed = int(rng.integers(n))
    for part in range(p):
        budget = target if part < p - 1 else np.inf
        acc = 0.0
        # BFS frontier seeded at an unassigned vertex adjacent to the last part
        if parts[cur_seed] != -1:
            cand = np.flatnonzero(parts == -1)
            if cand.size == 0:
                break
            cur_seed = int(cand[0])
        frontier = deque([cur_seed])    # the reference's list, FIFO
        in_frontier = np.zeros(n, bool)
        in_frontier[cur_seed] = True
        while frontier and acc < budget and unassigned > 0:
            v = frontier.popleft()
            if parts[v] != -1:
                continue
            if acc + weights[v] > budget and acc > 0 and part < p - 1:
                break
            parts[v] = part
            acc += weights[v]
            unassigned -= 1
            for w_ in indices[indptr[v]:indptr[v + 1]]:
                if parts[w_] == -1 and not in_frontier[w_]:
                    in_frontier[w_] = True
                    frontier.append(int(w_))
        # next seed: boundary vertex of what we just grew, else any
        nxt = -1
        if frontier:
            for f in frontier:
                if parts[f] == -1:
                    nxt = f
                    break
        if nxt == -1:
            cand = np.flatnonzero(parts == -1)
            if cand.size == 0:
                break
            nxt = int(cand[0])
        cur_seed = nxt
    # sweep leftovers (disconnected bits) to the lightest part
    leftovers = np.flatnonzero(parts == -1)
    if leftovers.size:
        pw = np.bincount(parts[parts >= 0], weights=weights[parts >= 0],
                         minlength=p)
        for v in leftovers:
            j = int(np.argmin(pw))
            parts[v] = j
            pw[j] += weights[v]
    return parts
