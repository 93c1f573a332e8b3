"""The port's FEM modules against the JAX package on shared inputs (CPU).

Meshes and refinement are numpy copies: identical arrays.  Assembly is
float32 with another det/inv and summation order: rtol 1e-5.  The solve
runs the element-matvec plain version against the JAX package's
geometry operator: relative L2 gap <= 1e-4 at tol 1e-6, iterations
within 2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fem as JF
import repro_torch.fem as TF
from repro.fem import estimate as jest
from repro_torch import interop
from repro_torch.fem import adapt as tadapt


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def assert_same_mesh(a, b):
    for f in ("verts", "node_tets", "node_tag", "node_mid", "leaf_nodes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for f in ("parent", "child0", "child1"):
        np.testing.assert_array_equal(getattr(a.forest, f),
                                      getattr(b.forest, f), err_msg=f)
    assert a.forest.n_roots == b.forest.n_roots
    assert a.edge_mid == b.edge_mid
    assert sorted(a.leaf_payload) == sorted(b.leaf_payload)
    for k in a.leaf_payload:
        np.testing.assert_array_equal(a.leaf_payload[k], b.leaf_payload[k])


@pytest.mark.parametrize("make", [
    lambda M: M.kuhn_box_mesh(2, 3, 1, lengths=(2.0, 1.0, 0.5)),
    lambda M: M.cylinder_mesh(8, 2, length=4.0, radius=0.5),
    lambda M: M.unit_cube_mesh(3)])
def test_mesh_constructors_identical(make):
    assert_same_mesh(make(TF), make(JF))


def _refined_pair(seed=0, rounds=3):
    jm = JF.cylinder_mesh(8, 2, length=4.0, radius=0.5)
    tm = TF.cylinder_mesh(8, 2, length=4.0, radius=0.5)
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        marked = rng.random(jm.n_tets) < 0.3
        jm.leaf_payload["parts"] = np.arange(jm.n_tets) % 5
        tm.leaf_payload["parts"] = np.arange(tm.n_tets) % 5
        assert JF.refine(jm, marked) == TF.refine(tm, marked)
    return jm, tm


def test_refine_coarsen_uniform_identical():
    jm, tm = _refined_pair()
    assert_same_mesh(tm, jm)
    rng = np.random.default_rng(1)
    marked = rng.random(jm.n_tets) < 0.6
    assert JF.coarsen(jm, marked) == TF.coarsen(tm, marked) > 0
    assert_same_mesh(tm, jm)
    JF.uniform_refine(jm, 2)
    TF.uniform_refine(tm, 2)
    assert_same_mesh(tm, jm)
    np.testing.assert_array_equal(tm.boundary_vertices(), jm.boundary_vertices())
    np.testing.assert_array_equal(tm.face_adjacency(), jm.face_adjacency())


def test_interop_round_trip():
    jm, _ = _refined_pair(seed=3)
    jm.leaf_payload["sfc_key"] = np.arange(jm.n_tets, dtype=np.uint32)
    tm = interop.mesh_from_numpy(jm)
    assert tm.leaf_payload["sfc_key"].dtype == np.int64
    back = interop.mesh_to_numpy(tm)
    from repro.core.rtree import RefinementForest
    jm2 = JF.Mesh(**{**back, "forest": RefinementForest(**back["forest"])})
    assert_same_mesh(interop.mesh_from_numpy(jm2), tm)
    tm.verts[0] += 1.0                                  # copies, not views
    assert jm.verts[0, 0] != tm.verts[0, 0]


def _elements():
    jm, _ = _refined_pair(seed=2, rounds=2)
    jel = JF.build_elements(jm.verts, jm.tets)
    tel = TF.build_elements(jm.verts, jm.tets, device="cpu")
    return jm, jel, tel


def _close(a, b, rtol=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(_np(a), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(initial=0.0), 1e-30))


def test_elements_and_operators_match():
    jm, jel, tel = _elements()
    np.testing.assert_array_equal(_np(tel.tets), np.asarray(jel.tets))
    assert tel.n_verts == jel.n_verts
    _close(tel.vol, jel.vol)
    _close(tel.grads, jel.grads)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(jm.n_verts).astype(np.float32)
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    for c in (0.0, 1.0, 25.0):
        _close(TF.stiffness_matvec(tel, tu, c), JF.stiffness_matvec(jel, ju, c))
        _close(TF.operator_diagonal(tel, c), JF.operator_diagonal(jel, c))
    _close(TF.mass_matvec(tel, tu), JF.mass_matvec(jel, ju))
    _close(TF.element_gradients(tel, tu), JF.element_gradients(jel, ju))
    jp, tp = JF.HelmholtzProblem(), TF.HelmholtzProblem()
    verts32 = jm.verts.astype(np.float32)
    _close(TF.load_vector(tel, torch.as_tensor(verts32), tp.f),
           JF.load_vector(jel, jnp.asarray(verts32), jp.f))


def test_problems_match():
    rng = np.random.default_rng(4)
    x = rng.random((500, 3)).astype(np.float32)
    jp, tp = JF.ParabolicProblem(), TF.ParabolicProblem()
    for t in (0.0, 0.13):
        _close(tp.exact(torch.as_tensor(x), t), jp.exact(jnp.asarray(x), t))
        _close(tp.f(torch.as_tensor(x), t), jp.f(jnp.asarray(x), t), rtol=1e-4)
    hp, jh = TF.HelmholtzProblem(), JF.HelmholtzProblem()
    _close(hp.f(torch.as_tensor(x)), jh.f(jnp.asarray(x)))


@pytest.mark.parametrize("c", [1.0, 100.0])
def test_solve_dirichlet_matches(c):
    jm, jel, tel = _elements()
    prob = TF.HelmholtzProblem()
    verts32 = jm.verts.astype(np.float32)
    tv = torch.as_tensor(verts32)
    rhs = TF.load_vector(tel, tv, prob.f)
    free_np = np.ones(jm.n_verts, np.float32)
    free_np[jm.boundary_vertices()] = 0.0
    free = tadapt.free_mask(interop.mesh_from_numpy(jm), "cpu")
    np.testing.assert_array_equal(_np(free), free_np)
    g = prob.exact(tv)
    got = TF.solve_dirichlet(tel, rhs, g, free, c, tol=1e-6)
    want = JF.solve_dirichlet(jel, jnp.asarray(_np(rhs)), jnp.asarray(_np(g)),
                              jnp.asarray(free_np), c, tol=1e-6)
    x, y = _np(got.x), np.asarray(want.x)
    assert np.linalg.norm(x - y) <= 1e-4 * np.linalg.norm(y)
    assert abs(got.iters - int(want.iters)) <= 2


def test_zz_estimate_and_marking_match():
    jm, jel, tel = _elements()
    rng = np.random.default_rng(5)
    u = rng.standard_normal(jm.n_verts).astype(np.float32)
    eta = TF.zz_estimate(tel, torch.as_tensor(u))
    jeta = JF.zz_estimate(jel, jnp.asarray(u))
    _close(eta, jeta, rtol=1e-4)
    e = np.asarray(jeta)
    for theta in (0.3, 0.5, 1.0):
        np.testing.assert_array_equal(TF.doerfler_mark(e, theta),
                                      jest.doerfler_mark(e, theta))
    np.testing.assert_array_equal(TF.threshold_coarsen_mark(e, 0.5),
                                  jest.threshold_coarsen_mark(e, 0.5))


def test_transfer_p1_matches():
    jm, tm = _refined_pair(seed=6, rounds=1)
    active = np.zeros(jm.n_verts, bool)
    active[np.unique(jm.tets)] = True
    u = np.random.default_rng(6).standard_normal(jm.n_verts)
    marked = np.random.default_rng(7).random(jm.n_tets) < 0.4
    JF.refine(jm, marked)
    TF.refine(tm, marked)
    np.testing.assert_array_equal(TF.transfer_p1(u, active, tm),
                                  JF.transfer_p1(u, active, jm))


@pytest.mark.parametrize("maxiter", [5, 2000])
def test_pcg_matches_reference_pcg(maxiter):
    """The PCG loop alone, on one dense SPD system: same iterations (the
    cap is honoured) and the same solution to float32 rounding."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((40, 40)).astype(np.float32)
    a = (q @ q.T + 40.0 * np.eye(40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    d = np.diag(a).copy()
    ta, tb, td = (torch.as_tensor(x) for x in (a, b, d))
    ja, jb, jd = (jnp.asarray(x) for x in (a, b, d))
    got = TF.pcg(lambda v: ta @ v, tb, td, torch.zeros_like(tb), tol=1e-6,
                 maxiter=maxiter)
    want = JF.solve.pcg(lambda v: ja @ v, jb, jd, jnp.zeros_like(jb),
                        tol=1e-6, maxiter=maxiter)
    assert abs(got.iters - int(want.iters)) <= 1
    assert got.iters <= maxiter
    y = np.asarray(want.x)
    assert np.linalg.norm(_np(got.x) - y) <= 1e-4 * np.linalg.norm(y)
    if maxiter == 2000:
        assert float(got.residual) <= 1e-6
