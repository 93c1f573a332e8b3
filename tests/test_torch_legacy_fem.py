"""The deprecated adaptive-FEM drivers of the port against the JAX
package's, on the CPU: ``solve_helmholtz_adaptive`` (paper Example 3.1)
and ``solve_parabolic_adaptive`` (Example 3.2) from the same mesh, and
``peak_init``.

The meshes follow the Dörfler marking of float32 error indicators, so
the step statistics are held as the session tests hold them: the same
mesh sizes, partitions' imbalance, repartitions and migration, cg_iters
within 2, and err_l2 and the estimate eta within 1e-4 (relative).
"""
import warnings

import numpy as np
import pytest

import repro.fem as JF
import repro.fem.adapt as JA
import repro_torch.fem as TF

CASES = {
    "solve_helmholtz_adaptive": (
        lambda M: M.cylinder_mesh(8, 2, length=4.0, radius=0.5),
        dict(p=16, max_steps=3, max_tets=6000, tol=1e-6)),
    "solve_parabolic_adaptive": (
        lambda M: M.unit_cube_mesh(2),
        dict(p=8, dt=0.02, n_steps=2, max_tets=3000, tol=1e-6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_driver_matches_reference(name):
    mesh, kw = CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = getattr(JF, name)(mesh(JF), **kw)
        got = getattr(TF, name)(mesh(TF), device="cpu", **kw)
    assert len(got.stats) == len(want.stats) >= 2
    assert got.n_repartitions == want.n_repartitions
    for a, b in zip(got.stats, want.stats):
        assert (a.n_tets, a.n_verts, a.repartitioned, a.cut) == (
            b.n_tets, b.n_verts, b.repartitioned, b.cut)
        assert a.imbalance == b.imbalance
        assert (a.migration_totalv, a.migration_retained) == (
            b.migration_totalv, b.migration_retained)
        assert abs(a.cg_iters - b.cg_iters) <= 2
        assert abs(a.err_l2 - b.err_l2) <= 1e-4 * abs(b.err_l2)
        assert abs(a.eta - b.eta) <= 1e-4 * abs(b.eta)
    assert got.u.shape == (got.mesh.n_verts,)
    assert got.spec.to_dict() == want.spec.to_dict()


def test_peak_init_matches_reference():
    tmesh, jmesh = TF.unit_cube_mesh(3), JF.unit_cube_mesh(3)
    got = TF.peak_init(tmesh, TF.ParabolicProblem(), device="cpu")
    want = np.asarray(JA.peak_init(jmesh, JF.ParabolicProblem()))
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
