"""Refinement-tree (RTK) partitioning -- paper section 2.1, Algorithm 1.

The mesh keeps its leaves in the DFS order of the refinement forest (a
bisected parent is replaced by its two children in place), so RTK is one
prefix sum over the leaf weights: leaf i with S_i = sum_{j<i} w_j goes to
part j iff S_i in [W*j/p, W*(j+1)/p).

``RefinementForest`` is the explicit host-side forest (numpy), a copy of
``repro.core.rtree``'s: the mesh needs it for coarsening.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from .partition1d import prefix_sum_parts


def partition_dfs(leaf_weights_dfs: torch.Tensor, p: int) -> torch.Tensor:
    """RTK partition of leaves given in DFS order.  Pure Algorithm 1."""
    return prefix_sum_parts(leaf_weights_dfs, p)


@dataclass
class RefinementForest:
    """Append-only binary refinement forest (host side, like PHG's tree).

    ``child0/child1 == -1`` marks a leaf.  Roots are the initial elements,
    in fixed creation order (the paper's root ordering invariant)."""
    parent: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    child0: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    child1: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    n_roots: int = 0

    @classmethod
    def from_roots(cls, n_roots: int) -> "RefinementForest":
        return cls(parent=np.full(n_roots, -1, np.int64),
                   child0=np.full(n_roots, -1, np.int64),
                   child1=np.full(n_roots, -1, np.int64),
                   n_roots=n_roots)

    @property
    def n_nodes(self) -> int:
        return self.parent.shape[0]

    def split(self, nodes: np.ndarray) -> np.ndarray:
        """Bisect ``nodes`` (must be leaves).  Returns (m, 2) child ids."""
        nodes = np.asarray(nodes, np.int64)
        if not (self.child0[nodes] == -1).all():
            raise ValueError("split of non-leaf")
        m = nodes.shape[0]
        base = self.n_nodes
        kids = base + np.arange(2 * m, dtype=np.int64).reshape(m, 2)
        self.parent = np.concatenate([self.parent, np.repeat(nodes, 2)])
        self.child0 = np.concatenate([self.child0, np.full(2 * m, -1, np.int64)])
        self.child1 = np.concatenate([self.child1, np.full(2 * m, -1, np.int64)])
        self.child0[nodes] = kids[:, 0]
        self.child1[nodes] = kids[:, 1]
        return kids

    def coarsen(self, parents: np.ndarray) -> None:
        """Undo the split of ``parents`` (children must be leaves)."""
        parents = np.asarray(parents, np.int64)
        c0, c1 = self.child0[parents], self.child1[parents]
        if not ((c0 >= 0).all() and (self.child0[c0] == -1).all()
                and (self.child0[c1] == -1).all()):
            raise ValueError("coarsen needs parents whose children are leaves")
        self.child0[parents] = -1
        self.child1[parents] = -1

    def leaves_dfs(self) -> np.ndarray:
        """Leaf node ids in DFS order (left child first, roots in order)."""
        out: List[int] = []
        stack: List[int] = list(range(self.n_roots - 1, -1, -1))
        c0, c1 = self.child0, self.child1
        while stack:
            n = stack.pop()
            if c0[n] == -1:
                out.append(n)
            else:
                stack.append(int(c1[n]))
                stack.append(int(c0[n]))
        return np.asarray(out, np.int64)


def rtk_partition_forest(forest: RefinementForest, weights_by_node: np.ndarray,
                         p: int) -> np.ndarray:
    """Full RTK on an explicit forest: traverse for DFS order, then Alg. 1
    (host arrays in and out).  Part id per leaf, in ``leaves_dfs`` order."""
    order = forest.leaves_dfs()
    w = torch.as_tensor(np.asarray(weights_by_node)[order])
    return partition_dfs(w, p).numpy()
