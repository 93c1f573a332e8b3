"""Tetrahedral mesh for the adaptive-FEM substrate.

Host-side (numpy) control plane -- the analogue of PHG's mesh object, a
copy of ``repro.fem.mesh`` that gives identical vertex and tet order.  The
compute plane (assembly/solve) copies leaf arrays to the device.

Design notes
------------
* The refinement forest (``core.rtree.RefinementForest``) is stored
  explicitly, like PHG.  Node data (vertex ids, Maubach tag, midpoint) are
  append-only arrays indexed by forest node id.
* ``leaf_nodes`` lists active leaves **in DFS order** and is maintained
  incrementally: bisection replaces a parent by its two children in place
  (left child at the parent's slot).  This materializes the refinement-tree
  traversal order so RTK partitioning is a single cumsum.
* Initial meshes are Kuhn-triangulated boxes (6 tets/cube, tag 3), the
  canonical *reflected* family for which Maubach bisection is conforming
  and terminating.  The cylinder of the paper's Example 3.1 is produced by
  radially mapping the box cross-section to a disk.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from ..core.rtree import RefinementForest

_EDGE_SHIFT = 32  # edge key = (min << 32) | max


def edge_key(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lo = np.minimum(a, b).astype(np.int64)
    hi = np.maximum(a, b).astype(np.int64)
    return (lo << _EDGE_SHIFT) | hi


# The 6 edges of a tet as local vertex index pairs.
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)
# The 4 faces (opposite each vertex).
TET_FACES = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], np.int64)


@dataclass
class Mesh:
    verts: np.ndarray                  # (nv, 3) float64
    node_tets: np.ndarray              # (nn, 4) int64 vertex ids per forest node
    node_tag: np.ndarray               # (nn,) int8 Maubach tag (1..3)
    node_mid: np.ndarray               # (nn,) int64 midpoint vertex if split
    forest: RefinementForest
    leaf_nodes: np.ndarray             # (nt,) int64 active leaves, DFS order
    edge_mid: Dict[int, int] = field(default_factory=dict)  # edge key -> vertex
    # per-leaf arrays propagated through refine/coarsen (e.g. 'parts')
    leaf_payload: Dict[str, np.ndarray] = field(default_factory=dict)

    # ---- views -----------------------------------------------------------
    @property
    def n_verts(self) -> int:
        return self.verts.shape[0]

    @property
    def n_tets(self) -> int:
        return self.leaf_nodes.shape[0]

    @property
    def tets(self) -> np.ndarray:
        """(nt, 4) leaf tets in DFS order."""
        return self.node_tets[self.leaf_nodes]

    @property
    def tags(self) -> np.ndarray:
        return self.node_tag[self.leaf_nodes]

    def leaf_edges(self) -> np.ndarray:
        """(nt, 6) int64 edge keys of every leaf tet."""
        t = self.tets
        a = t[:, TET_EDGES[:, 0]]
        b = t[:, TET_EDGES[:, 1]]
        return edge_key(a, b)

    def refinement_edges(self) -> np.ndarray:
        """(nt,) edge key of each leaf's refinement edge (v0, v_tag)."""
        t = self.tets
        d = self.tags.astype(np.int64)
        vd = t[np.arange(t.shape[0]), d]
        return edge_key(t[:, 0], vd)

    # ---- geometry --------------------------------------------------------
    def barycenters(self) -> np.ndarray:
        return self.verts[self.tets].mean(axis=1)

    def boundary_vertices(self) -> np.ndarray:
        """Vertex ids on the boundary (faces used by exactly one leaf tet)."""
        t = self.tets
        faces = np.sort(t[:, TET_FACES].reshape(-1, 3), axis=1)
        # unique face rows appearing once
        f, counts = np.unique(faces, axis=0, return_counts=True)
        bf = f[counts == 1]
        return np.unique(bf.reshape(-1))

    def face_adjacency(self) -> np.ndarray:
        """(m, 2) leaf-index pairs sharing a face (for cut metrics)."""
        t = self.tets
        nt = t.shape[0]
        faces = np.sort(t[:, TET_FACES].reshape(-1, 3), axis=1)
        owner = np.repeat(np.arange(nt, dtype=np.int64), 4)
        order = np.lexsort((faces[:, 2], faces[:, 1], faces[:, 0]))
        fs, ow = faces[order], owner[order]
        same = (fs[1:] == fs[:-1]).all(axis=1)
        return np.stack([ow[:-1][same], ow[1:][same]], axis=1)


# ---------------------------------------------------------------------------
# Initial meshes
# ---------------------------------------------------------------------------

# Kuhn triangulation of the unit cube: 6 tets along vertex-permutation paths
# (0,0,0) -> +e_{pi(0)} -> +e_{pi(1)} -> +e_{pi(2)}, each ordered so that the
# path endpoints are v0=(0,0,0), v3=(1,1,1).  Tag 3 (refinement edge = main
# diagonal v0--v3) gives the reflected family.
_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def kuhn_box_mesh(nx: int, ny: int, nz: int,
                  lengths: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                  origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
                  ) -> Mesh:
    """Structured box (nx, ny, nz) cubes, 6 Kuhn tets each."""
    nvx, nvy, nvz = nx + 1, ny + 1, nz + 1
    xs = np.linspace(0, 1, nvx) * lengths[0] + origin[0]
    ys = np.linspace(0, 1, nvy) * lengths[1] + origin[1]
    zs = np.linspace(0, 1, nvz) * lengths[2] + origin[2]
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * nvy + j) * nvz + k

    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                base = np.array([i, j, k])
                for perm in _PERMS:
                    p = [base.copy()]
                    cur = base.copy()
                    for ax in perm:
                        cur = cur.copy()
                        cur[ax] += 1
                        p.append(cur)
                    tets.append([vid(*q) for q in p])
    node_tets = np.asarray(tets, np.int64)
    nn = node_tets.shape[0]
    forest = RefinementForest.from_roots(nn)
    return Mesh(verts=verts,
                node_tets=node_tets,
                node_tag=np.full(nn, 3, np.int8),
                node_mid=np.full(nn, -1, np.int64),
                forest=forest,
                leaf_nodes=np.arange(nn, dtype=np.int64))


def cylinder_mesh(n_axial: int = 20, n_cross: int = 2,
                  length: float = 10.0, radius: float = 0.5) -> Mesh:
    """Paper Example 3.1 domain: a long thin cylinder (high aspect ratio).

    Box (length x 2r x 2r) Kuhn mesh with its square cross-section mapped
    radially onto a disk (the standard square->disk map, applied to the
    initial vertices only)."""
    m = kuhn_box_mesh(n_axial, n_cross, n_cross,
                      lengths=(length, 2 * radius, 2 * radius),
                      origin=(0.0, -radius, -radius))
    y = m.verts[:, 1] / radius
    z = m.verts[:, 2] / radius
    # square -> disk (elliptical map preserves the Kuhn connectivity)
    yn = y * np.sqrt(np.maximum(0.0, 1 - z * z / 2))
    zn = z * np.sqrt(np.maximum(0.0, 1 - y * y / 2))
    m.verts[:, 1] = yn * radius
    m.verts[:, 2] = zn * radius
    return m


def unit_cube_mesh(n: int = 4) -> Mesh:
    """Paper Example 3.2 domain: (0,1)^3."""
    return kuhn_box_mesh(n, n, n)
