"""The slice as a whole: the adaptive session against the JAX package (CPU).

(a) Exact balance replay: the JAX package's ``AdaptiveSession`` runs at
    the quickstart's smoke size; at every balance stage its mesh (with
    the inherited parts and cached keys) is carried across with
    ``interop.mesh_from_numpy`` and the port's balance stage runs on it.
    Parts, imbalance, TotalV, retained and splitters must be identical.
(b) End to end: the port's own session from the same initial mesh.  The
    Dörfler marking sorts float32 error indicators whose last bits differ
    between the packages, so meshes may part at ties: n_tets within 1 %,
    err_l2 within 2 %, the same number of repartitions.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro.fem as JF
import repro_torch.fem as TF
from repro_torch import interop
from repro_torch.core import BalanceSpec
from repro_torch.fem import adapt as tadapt

CASES = [("sorted", False, "imbalance"), ("ksection", False, "imbalance"),
         ("ksection", True, "always")]


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _spec(oneD, incremental, trigger):
    return JF.AdaptSpec.for_problem(
        "helmholtz", max_steps=3, max_tets=6000, tol=1e-6,
        incremental=incremental, trigger=trigger,
        balance=J.BalanceSpec(p=16, method="hsfc", oneD=oneD))


def _reference_run(spec):
    """The JAX session, with each balance stage's input mesh captured."""
    sess = JF.AdaptiveSession(spec)
    captured = []
    stage = sess._stages["balance"]

    def balance_and_capture(session, state):
        before = interop.mesh_from_numpy(state.mesh)
        stage(session, state)
        captured.append((state.step, before, state.repartitioned,
                         state.balance_result, state.step_imbalance,
                         state.migration_totalv, state.migration_retained,
                         np.asarray(state.mesh.leaf_payload["parts"])))
    sess._stages["balance"] = balance_and_capture
    res = sess.run(JF.cylinder_mesh(8, 2, length=4.0, radius=0.5))
    return res, captured


@pytest.mark.parametrize("oneD,incremental,trigger", CASES)
def test_session_balance_replay_and_end_to_end(oneD, incremental, trigger):
    spec = _spec(oneD, incremental, trigger)
    ref, captured = _reference_run(spec)
    tspec = TF.AdaptSpec.from_dict(spec.to_dict())

    # (a) the port's balance stage on the reference's mesh at every step
    port = TF.AdaptiveSession(tspec, device="cpu")
    assert len(captured) == len(ref.stats)
    for (step, mesh, rep, br, imb, totalv, retained, parts) in captured:
        st = tadapt.SessionState(mesh=mesh, step=step)
        tadapt._balance_common(port, st)
        assert st.repartitioned == rep
        assert st.step_imbalance == imb
        assert st.migration_totalv == totalv
        assert st.migration_retained == retained
        np.testing.assert_array_equal(mesh.leaf_payload["parts"], parts)
        if rep:
            got = st.balance_result
            for f in ("parts", "part_weights", "imbalance", "total_v",
                      "max_v", "retained", "remap_perm", "splitters"):
                np.testing.assert_array_equal(
                    _np(getattr(got, f)), np.asarray(getattr(br, f)),
                    err_msg=f"step {step} field {f}")
            if oneD == "ksection":
                assert got.ksection_rounds == int(br.ksection_rounds)
        if incremental:
            assert st.key_info["mode"] in ("full", "delta")
    if incremental:
        assert st.key_info["mode"] == "delta"       # the cache was reused

    # (b) the port's own session end to end
    res = TF.AdaptiveSession(tspec, device="cpu").run(
        TF.cylinder_mesh(8, 2, length=4.0, radius=0.5))
    assert res.n_repartitions == ref.n_repartitions
    assert len(res.stats) == len(ref.stats)
    for a, b in zip(res.stats, ref.stats):
        assert abs(a.n_tets - b.n_tets) <= 0.01 * b.n_tets
        assert abs(a.err_l2 - b.err_l2) <= 0.02 * b.err_l2
        assert a.repartitioned == b.repartitioned
    assert res.u.shape == (res.mesh.n_verts,)


def test_parabolic_session_runs():
    """The time-dependent loop (coarsen_refine, transfer, backward Euler)
    on the port alone; its pieces are held against the JAX package in
    test_torch_fem.py."""
    spec = TF.AdaptSpec.for_problem("parabolic", n_steps=3, max_tets=3000,
                                    tol=1e-6,
                                    balance=BalanceSpec(p=8, method="rtk"))
    res = TF.AdaptiveSession(spec, device="cpu").run(TF.unit_cube_mesh(3))
    assert res.n_repartitions == 3                 # trigger='always'
    assert all(np.isfinite(s.err_l2) and s.err_l2 < 0.1 for s in res.stats)
    assert all(s.migration_retained > 0 for s in res.stats[1:])
    assert res.u.shape == (res.mesh.n_verts,)
