"""``core.graph_greedy``: the graph-growing baseline (the paper's ParMETIS
stand-in), host numpy in both packages, held bit for bit against the JAX
package's on a tet mesh's dual graph (unit weights and seeded random
weights) and on a graph with disconnected pieces and isolated vertices
(whose leftovers the partitioner sweeps to the lightest part)."""
import numpy as np
import pytest

from repro.core import graph_greedy as jgg
from repro_torch.core import graph_greedy as gg
from repro_torch.core import greedy_graph_partition
from repro_torch.fem import kuhn_box_mesh


def _dual_graph():
    mesh = kuhn_box_mesh(6, 5, 4)
    pairs = mesh.face_adjacency()
    rng = np.random.default_rng(3)
    return mesh.n_tets, pairs, rng.uniform(0.5, 2.0, mesh.n_tets)


def _disconnected():
    """Two copies of the dual graph side by side, then 7 isolated
    vertices: BFS cannot reach everything from one seed."""
    n, pairs, w = _dual_graph()
    pairs = np.concatenate([pairs, pairs + n])
    weights = np.concatenate([w, w[::-1], np.full(7, 3.0)])
    return 2 * n + 7, pairs, weights


def _dual_unit():
    n, pairs, _ = _dual_graph()
    return n, pairs, np.ones(n)


GRAPHS = {"dual": _dual_graph, "dual-unit": _dual_unit,
          "disconnected": _disconnected}


@pytest.mark.parametrize("p", [2, 8, 64])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_partition_equals_the_reference(graph, p):
    n, pairs, w = GRAPHS[graph]()
    got = greedy_graph_partition(n, pairs, w, p, seed=p)
    want = jgg.greedy_graph_partition(n, pairs, w, p, seed=p)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < p


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_csr_equals_the_reference(graph):
    n, pairs, _ = GRAPHS[graph]()
    for a, b in zip(gg._csr_from_pairs(n, pairs),
                    jgg._csr_from_pairs(n, pairs)):
        np.testing.assert_array_equal(a, b)
