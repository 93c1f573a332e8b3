"""Maubach bisection with conformity closure, DFS-order preserving.

Bisection rule (Maubach 1995, the scheme PHG's bisection is equivalent to):
simplex (v0, v1, v2, v3) with tag d in {1,2,3} bisects edge (v0, vd) at its
midpoint m:

    child1 = (v0, ..., v_{d-1}, m, v_{d+1}, ..., v3)
    child2 = (v1, ..., v_d,     m, v_{d+1}, ..., v3)

both with tag d-1 (tag 3 if d was 1).  For reflected initial meshes (Kuhn
boxes, tag 3) repeated bisection is conforming and terminates.

``refine(mesh, marked)`` performs marked refinement + closure:

  1. closure: repeatedly mark every leaf whose refinement edge is already
     scheduled for splitting, and every leaf containing a scheduled edge
     whose own refinement edge must then also be scheduled;
  2. split all marked leaves simultaneously (children replace the parent
     adjacently in the DFS leaf order -- the RTK invariant);
  3. any leaf now containing a hanging edge (an edge whose midpoint vertex
     exists) is marked and the loop repeats until conforming.

``coarsen(mesh, marked)`` undoes bisections: a parent whose two children
are leaves, both marked, and whose midpoint vertex is used only by such
sibling groups, is restored.  (Paper Example 3.2 requires refine+coarsen.)
"""
from __future__ import annotations

import numpy as np

from .mesh import Mesh, edge_key


def _split_once(mesh: Mesh, marked: np.ndarray) -> None:
    """Bisect all marked leaves (bool mask over DFS leaf order) in place.

    Any arrays in ``mesh.leaf_payload`` (dict name -> (nt, ...) array) are
    propagated: children inherit the parent's value (np.repeat).  Used to
    carry part assignments through adaptation (the paper's incremental-DLB
    setting: the old partition is meaningful for the new mesh)."""
    if not marked.any():
        return
    leaf = mesh.leaf_nodes
    tets = mesh.node_tets[leaf[marked]]           # (m, 4)
    tags = mesh.node_tag[leaf[marked]].astype(np.int64)  # (m,)
    m = tets.shape[0]

    # --- midpoint vertices (deduplicated via edge_mid) ---------------------
    v0 = tets[:, 0]
    vd = tets[np.arange(m), tags]
    ek = edge_key(v0, vd)
    mid = np.full(m, -1, np.int64)
    # reuse existing midpoints
    for i, k in enumerate(ek):
        mid[i] = mesh.edge_mid.get(int(k), -1)
    need = mid < 0
    if need.any():
        uk, first = np.unique(ek[need], return_index=True)
        # create one vertex per unique new edge
        sub_v0 = v0[need][first]
        sub_vd = vd[need][first]
        new_xyz = 0.5 * (mesh.verts[sub_v0] + mesh.verts[sub_vd])
        base = mesh.n_verts
        mesh.verts = np.concatenate([mesh.verts, new_xyz], axis=0)
        lut = {int(k): base + i for i, k in enumerate(uk)}
        for i in np.flatnonzero(need):
            mesh.edge_mid[int(ek[i])] = lut[int(ek[i])]
            mid[i] = lut[int(ek[i])]

    # --- child tets (vectorized over the three tag values) -----------------
    c1 = tets.copy()
    c1[np.arange(m), tags] = mid                  # replace v_d by m
    c2 = np.empty_like(tets)
    for d in (1, 2, 3):
        rows = tags == d
        if not rows.any():
            continue
        # child2 = (v1..vd, m, v_{d+1}..v3)
        src = tets[rows]
        out = np.empty_like(src)
        out[:, :d] = src[:, 1:d + 1]
        out[:, d] = mid[rows]
        out[:, d + 1:] = src[:, d + 1:]
        c2[rows] = out
    child_tag = np.where(tags == 1, 3, tags - 1).astype(np.int8)

    # --- forest + node data -------------------------------------------------
    kids = mesh.forest.split(leaf[marked])        # (m, 2)
    mesh.node_mid[leaf[marked]] = mid
    mesh.node_tets = np.concatenate([mesh.node_tets,
                                     np.stack([c1, c2], axis=1).reshape(-1, 4)])
    mesh.node_tag = np.concatenate([mesh.node_tag,
                                    np.repeat(child_tag, 2)])
    mesh.node_mid = np.concatenate([mesh.node_mid,
                                    np.full(2 * m, -1, np.int64)])

    # --- DFS leaf order: children replace parent adjacently ----------------
    counts = np.where(marked, 2, 1)
    starts = np.cumsum(counts) - counts
    new_leaf = np.empty(int(counts.sum()), np.int64)
    new_leaf[starts[~marked]] = leaf[~marked]
    new_leaf[starts[marked]] = kids[:, 0]
    new_leaf[starts[marked] + 1] = kids[:, 1]
    mesh.leaf_nodes = new_leaf
    for name, arr in getattr(mesh, "leaf_payload", {}).items():
        mesh.leaf_payload[name] = np.repeat(arr, counts, axis=0)


def _hanging_mask(mesh: Mesh) -> np.ndarray:
    """Leaves containing an edge whose midpoint vertex already exists."""
    if not mesh.edge_mid:
        return np.zeros(mesh.n_tets, bool)
    keys = np.fromiter(mesh.edge_mid.keys(), np.int64, len(mesh.edge_mid))
    keys.sort()
    le = mesh.leaf_edges()                        # (nt, 6)
    pos = np.searchsorted(keys, le)
    pos = np.clip(pos, 0, keys.size - 1)
    hit = keys[pos] == le
    return hit.any(axis=1)


def refine(mesh: Mesh, marked: np.ndarray, max_rounds: int = 100) -> int:
    """Refine marked leaves + conformity closure.  Returns #bisections."""
    marked = np.asarray(marked, bool).copy()
    n_splits = 0
    for _ in range(max_rounds):
        if not marked.any():
            break
        # closure: everything whose refinement edge coincides with a
        # scheduled split edge must split too (fixpoint).
        while True:
            ref_e = mesh.refinement_edges()
            sched = np.unique(ref_e[marked])
            pos = np.searchsorted(sched, ref_e)
            pos = np.clip(pos, 0, max(sched.size - 1, 0))
            same_edge = sched.size > 0
            hit = (sched[pos] == ref_e) if same_edge else np.zeros_like(marked)
            newly = hit & ~marked
            if not newly.any():
                break
            marked |= newly
        n_splits += int(marked.sum())
        _split_once(mesh, marked)
        marked = _hanging_mask(mesh)
    else:
        raise RuntimeError("refine did not reach conformity")
    return n_splits


def uniform_refine(mesh: Mesh, rounds: int = 1) -> None:
    for _ in range(rounds):
        refine(mesh, np.ones(mesh.n_tets, bool))


def coarsen(mesh: Mesh, marked: np.ndarray) -> int:
    """Coarsen: undo bisections whose two children are marked leaves.

    Safe rule: the parent's midpoint vertex must be used *only* by children
    of parents in the candidate set (so removing them leaves no dangling
    reference).  Returns number of merges performed.
    """
    marked = np.asarray(marked, bool)
    leaf = mesh.leaf_nodes
    par = mesh.forest.parent[leaf]
    # sibling pairs are adjacent in DFS order with the same parent
    same = (par[:-1] == par[1:]) & (par[:-1] >= 0)
    both_marked = marked[:-1] & marked[1:]
    cand_pos = np.flatnonzero(same & both_marked)       # position of child0
    if cand_pos.size == 0:
        return 0
    cand_par = par[cand_pos]
    mids = mesh.node_mid[cand_par]

    # usage check: count leaf tets using each midpoint vertex
    t = mesh.tets
    use_count = np.zeros(mesh.n_verts, np.int64)
    np.add.at(use_count, t.reshape(-1), 1)
    # children of candidate parents that use the midpoint:
    child_use = np.zeros(mesh.n_verts, np.int64)
    pair_tets = np.concatenate([t[cand_pos], t[cand_pos + 1]], axis=0)
    np.add.at(child_use, pair_tets.reshape(-1), 1)
    ok = use_count[mids] == child_use[mids]
    cand_pos, cand_par, mids = cand_pos[ok], cand_par[ok], mids[ok]
    if cand_pos.size == 0:
        return 0

    # restore parents
    mesh.forest.coarsen(cand_par)
    # remove edge_mid entries so the midpoint no longer counts as hanging
    pt = mesh.node_tets[cand_par]
    pd = mesh.node_tag[cand_par].astype(np.int64)
    pek = edge_key(pt[:, 0], pt[np.arange(pt.shape[0]), pd])
    for k in pek:
        mesh.edge_mid.pop(int(k), None)
    mesh.node_mid[cand_par] = -1

    keep = np.ones(leaf.size, bool)
    keep[cand_pos + 1] = False
    new_leaf = leaf.copy()
    new_leaf[cand_pos] = cand_par
    mesh.leaf_nodes = new_leaf[keep]
    for name, arr in getattr(mesh, "leaf_payload", {}).items():
        mesh.leaf_payload[name] = arr[keep]  # parent takes child0's value
    # NOTE: orphaned midpoint vertices stay in ``verts`` (append-only);
    # they are unreferenced and harmless, compacted on checkpoint save.
    return int(cand_pos.size)
