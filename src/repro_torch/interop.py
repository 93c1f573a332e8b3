"""Carrying state between the JAX package and this one.

The system has no weights; its state is data: the mesh (with its
refinement forest and the per-leaf payloads -- parts, cached SFC keys)
and the specs.  Specs cross through ``to_dict`` / ``from_dict``.  Meshes
cross through the functions below, which copy arrays and never import
the other package: ``mesh_from_numpy`` takes any object (or dict) with
the ``Mesh`` fields, e.g. a ``repro.fem.Mesh``; ``mesh_to_numpy`` gives a
plain dict from which the caller rebuilds a mesh of either package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .core.rtree import RefinementForest
from .fem.mesh import Mesh

MESH_ARRAYS = ("verts", "node_tets", "node_tag", "node_mid", "leaf_nodes")
FOREST_ARRAYS = ("parent", "child0", "child1")


def _get(src: Any, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _payload_array(a) -> np.ndarray:
    a = np.array(a, copy=True)
    # unsigned keys (the JAX package's uint32) become int64, same values
    return a.astype(np.int64) if a.dtype.kind == "u" else a


def mesh_from_numpy(src: Any) -> Mesh:
    """A port ``Mesh`` holding copies of ``src``'s arrays.

    ``src``: a mesh of either package, or a dict as ``mesh_to_numpy``
    returns.  The copy shares nothing with ``src``."""
    forest = _get(src, "forest")
    f = RefinementForest(
        **{k: np.array(_get(forest, k), np.int64) for k in FOREST_ARRAYS},
        n_roots=int(_get(forest, "n_roots")))
    kw = {k: np.array(_get(src, k), copy=True) for k in MESH_ARRAYS}
    return Mesh(forest=f,
                edge_mid={int(k): int(v) for k, v in _get(src, "edge_mid").items()},
                leaf_payload={k: _payload_array(v)
                              for k, v in _get(src, "leaf_payload").items()},
                **kw)


def mesh_to_numpy(mesh: Mesh) -> Dict[str, Any]:
    """Plain copies of a port ``Mesh``'s fields: the mesh arrays,
    ``forest`` as a dict of its arrays and ``n_roots``, ``edge_mid`` and
    ``leaf_payload``.  ``mesh_from_numpy`` takes it back; a mesh of the
    JAX package is ``Mesh(**d)`` with ``forest=RefinementForest(**d['forest'])``."""
    out: Dict[str, Any] = {k: np.array(getattr(mesh, k), copy=True)
                           for k in MESH_ARRAYS}
    out["forest"] = {k: np.array(getattr(mesh.forest, k), copy=True)
                     for k in FOREST_ARRAYS}
    out["forest"]["n_roots"] = int(mesh.forest.n_roots)
    out["edge_mid"] = dict(mesh.edge_mid)
    out["leaf_payload"] = {k: np.array(v, copy=True)
                           for k, v in mesh.leaf_payload.items()}
    return out
