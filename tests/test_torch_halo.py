"""The port's owned-vertex layer (halo plan, element packers, replicated
and owned matvec, owned PCG) and the sharded ``AdaptiveSession`` against
the JAX package, on the CPU.

The plan builders are host numpy in both packages: their fields must be
identical.  The multi-rank pieces run in one gloo world of 4 CPU ranks
(module fixture; rank bodies in ``_torch_world.py``).  Under the
installed JAX the reference's owned-layout matvec is red (its
``shard_map(check_rep=...)``), so the owned matvec and PCG are held
against the reference's replicated-layout ``make_sharded_matvec``, its
``stiffness_matvec`` and its single-device ``solve_dirichlet``, within
1e-5 of the largest entry.  The sessions are held against the JAX
package's sharded session with the replicated layout, and every balance
stage of the port's sessions is replayed through the JAX package's
sharded ``Balancer``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro.fem as JF
from repro.fem import parallel as jpar
from repro.fem.solve import solve_dirichlet as j_solve_dirichlet
from repro_torch import interop
from repro_torch.fem import halo as thalo

import _torch_world as W

P4 = 4
PLAN_ARRAYS = ("local_verts", "owned_mask", "global_to_local", "send_idx",
               "recv_idx", "owner")
PLAN_SIZES = ("p", "n_verts", "V", "H", "n_local", "n_owned",
              "n_ghost_total")
TOL = 1e-5          # of the largest |entry|: float32 sums in other orders


def _mesh(refine=2):
    mesh = JF.cylinder_mesh(8, 2, length=4.0, radius=0.5)
    JF.uniform_refine(mesh, refine)
    return mesh


def _parts(mesh, p):
    res = J.Balancer(J.BalanceSpec(p=p, method="hsfc")).balance(
        jnp.ones(mesh.n_tets), coords=jnp.asarray(mesh.barycenters()))
    return np.asarray(res.parts).astype(np.int64)


def _assert_plan_equal(got, want):
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in PLAN_SIZES:
        assert getattr(got, f) == getattr(want, f), f


# --- the plan (host numpy in both packages) -------------------------------------

@pytest.mark.parametrize("p", [2, 4, 8])
def test_build_halo_plan_matches_jax(p):
    mesh = _mesh()
    parts = _parts(mesh, p)
    want = JF.build_halo_plan(mesh.tets, parts, mesh.n_verts, p)
    got = thalo.build_halo_plan(mesh.tets, parts, mesh.n_verts, p)
    _assert_plan_equal(got, want)
    np.testing.assert_array_equal(got.shared_vertex_mask(),
                                  want.shared_vertex_mask())
    assert got.halo_bytes(4) == want.halo_bytes(4)
    assert got.psum_bytes(4) == want.psum_bytes(4)
    _assert_plan_equal(interop.halo_plan_from_jax(want), want)


@pytest.mark.parametrize("case", ["refine", "migrate", "noop"])
def test_update_halo_plan_matches_jax(case):
    """The delta builder after a refinement (children inherit parts), a
    migration-only step and no change: identical plans and info in both
    packages, and identical to a plan built from scratch."""
    mesh = _mesh()
    p = P4
    parts = _parts(mesh, p)
    old_tets = mesh.tets.copy()
    plan_j = JF.build_halo_plan(old_tets, parts, mesh.n_verts, p)
    plan_t = thalo.build_halo_plan(old_tets, parts, mesh.n_verts, p)
    new_parts = parts.copy()
    if case == "refine":
        mesh.leaf_payload["parts"] = parts
        marked = np.zeros(mesh.n_tets, bool)
        marked[::37] = True
        JF.refine(mesh, marked)
        new_parts = np.asarray(mesh.leaf_payload["parts"]).astype(np.int64)
    elif case == "migrate":
        new_parts[:40] = (new_parts[:40] + 1) % p
    want, info_j = JF.halo.update_halo_plan(
        plan_j, old_tets, parts, mesh.tets, new_parts, mesh.n_verts, p)
    got, info_t = thalo.update_halo_plan(
        plan_t, old_tets, parts, mesh.tets, new_parts, mesh.n_verts, p)
    _assert_plan_equal(got, want)
    assert info_t == info_j
    _assert_plan_equal(got, thalo.build_halo_plan(mesh.tets, new_parts,
                                                  mesh.n_verts, p))


# --- the multi-rank pieces ----------------------------------------------------------

def _numpy_sel(sel):
    """A JAX ``ShardedElements`` as plain numpy fields (picklable for the
    ranks, which import no JAX)."""
    halo = None
    if sel.halo is not None:
        halo = types.SimpleNamespace(
            **{f: np.asarray(getattr(sel.halo, f)) for f in PLAN_ARRAYS},
            **{f: getattr(sel.halo, f) for f in PLAN_SIZES})
    return types.SimpleNamespace(
        tets=np.asarray(sel.tets), grads=np.asarray(sel.grads),
        vol=np.asarray(sel.vol), n_verts=sel.n_verts, p=sel.p, halo=halo,
        layout=sel.layout, n_interface=sel.n_interface)


def _fem_setup():
    mesh = _mesh()
    parts = _parts(mesh, P4)
    el = JF.build_elements(mesh.verts, mesh.tets)
    plan = JF.build_halo_plan(mesh.tets, parts, mesh.n_verts, P4)
    sel = {"replicated": JF.parallel.shard_elements(el, parts, P4),
           "owned": JF.parallel.shard_elements(el, parts, P4, halo=plan)}
    rng = np.random.default_rng(5)
    u = rng.normal(size=mesh.n_verts).astype(np.float32)
    prob = JF.get_problem("helmholtz").make()
    verts = jnp.asarray(mesh.verts)
    rhs = np.asarray(JF.load_vector(el, verts, prob.f), np.float32)
    g = np.asarray(prob.exact(verts), np.float32)
    free = np.ones(mesh.n_verts, np.float32)
    free[mesh.boundary_vertices()] = 0.0
    return dict(mesh=mesh, parts=parts, el=el, plan=plan, sel=sel, u=u,
                rhs=rhs, g=g, free=free, c=float(prob.c))


SESSION_SPECS = [
    JF.AdaptSpec.for_problem(
        "helmholtz", max_steps=3, max_tets=8000, tol=1e-6, backend="sharded",
        vertex_layout=layout, balance=J.BalanceSpec(p=P4, method="hsfc"))
    for layout in ("replicated", "owned")]


@pytest.fixture(scope="module")
def setup():
    return _fem_setup()


@pytest.fixture(scope="module")
def jax_replicated(setup):
    """The JAX package's replicated-layout matvec and diagonal."""
    s = setup
    mv, _ = jpar.make_sharded_matvec(s["sel"]["replicated"],
                                     jpar.device_mesh(P4), s["c"])
    diag = jpar.sharded_diagonal(s["sel"]["replicated"],
                                 jpar.device_mesh(P4), s["c"])
    return np.asarray(mv(jnp.asarray(s["u"]))), np.asarray(diag)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    s = setup
    mesh_d = {"verts": np.asarray(s["mesh"].verts),
              "tets": np.asarray(s["mesh"].tets),
              "bary": s["mesh"].barycenters().astype(np.float32)}
    sel_rows = {k: _numpy_sel(v) for k, v in s["sel"].items()}
    from repro_torch.fem import unit_cube_mesh
    cube = interop.mesh_to_numpy(unit_cube_mesh(3))
    return W.world(W.fem_and_sessions,
                   (mesh_d, s["parts"], s["u"], s["c"], s["rhs"], s["free"],
                    s["g"], sel_rows),
                   (cube, [sp.to_dict() for sp in SESSION_SPECS]),
                   tmp_path=tmp_path_factory.mktemp("world"))


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


@pytest.mark.parametrize("layout", ["replicated", "owned"])
def test_packers_match_jax(setup, ranks, layout):
    """Both of the port's packers give each rank the JAX packers' row:
    the same elements in the same order (connectivity and interface split
    exact; geometry within float32 rounding of two inversions)."""
    s = setup
    halo = s["plan"] if layout == "owned" else None
    want_dev = jpar.shard_elements_on_device(
        s["el"], jnp.asarray(s["parts"]), P4, jpar.device_mesh(P4), halo=halo)
    want_host = s["sel"][layout]
    for r, o in enumerate(ranks):
        packs = o["fem"][layout + "_pack"]
        for got, want in ((packs["device"], want_dev),
                          (packs["host"], want_host)):
            tets, grads, vol, n_if = got
            np.testing.assert_array_equal(tets, np.asarray(want.tets[r]))
            np.testing.assert_allclose(grads, np.asarray(want.grads[r]),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(vol, np.asarray(want.vol[r]),
                                       rtol=1e-6, atol=1e-9)
            assert n_if == want.n_interface
        for a, b in zip(packs["device"][:3], packs["host"][:3]):
            np.testing.assert_array_equal(a, b)


def test_replicated_matvec_and_diagonal_match_jax(setup, ranks,
                                                  jax_replicated):
    s = setup
    want, want_d = jax_replicated
    _close(want, np.asarray(JF.stiffness_matvec(s["el"], jnp.asarray(s["u"]),
                                                s["c"])), "jax replicated")
    for o in ranks:
        _close(o["fem"]["rep_matvec"], want, "replicated matvec")
        _close(o["fem"]["rep_diag"], want_d, "replicated diagonal")


@pytest.mark.parametrize("overlap", [False, True])
def test_owned_matvec_matches_replicated(setup, ranks, jax_replicated,
                                        overlap):
    """The owned matvec (halo exchange, with and without the interface-
    first overlap), assembled back to (n_verts,), against the JAX
    package's replicated matvec; its local slots are ghost-consistent."""
    s = setup
    want, want_d = jax_replicated
    plan = s["plan"]
    for r, o in enumerate(ranks):
        _close(o["fem"][f"own_matvec_global_{overlap}"], want, "owned matvec")
        lv = np.asarray(plan.local_verts[r])
        real = lv < plan.n_verts
        _close(o["fem"][f"own_matvec_{overlap}"][real], want[lv[real]],
               "owned matvec, every local slot")
    _close(ranks[0]["fem"]["own_diag"], want_d, "owned diagonal")


@pytest.mark.parametrize("overlap", [False, True])
def test_owned_pcg_matches_replicated_solve(setup, ranks, overlap):
    s = setup
    want = j_solve_dirichlet(s["el"], jnp.asarray(s["rhs"]),
                             jnp.asarray(s["g"]), jnp.asarray(s["free"]),
                             s["c"], tol=1e-6)
    x_want = np.asarray(want.x)
    for o in ranks:
        x, iters = o["fem"][f"own_solve_{overlap}"]
        _close(x, x_want, "owned PCG solution")
        assert abs(iters - int(want.iters)) <= 2
    np.testing.assert_array_equal(ranks[0]["fem"][f"own_solve_{overlap}"][0],
                                  ranks[-1]["fem"][f"own_solve_{overlap}"][0])
    assert ranks[0]["fem"]["phases_ok"]


def test_reshard_elements_matches_jax(setup, ranks):
    """One DLB step for the FEM layer (sharded balance, halo plan, owned
    packing through the migration executor) gives each rank the JAX
    package's row and partition."""
    s = setup
    bary = s["mesh"].barycenters().astype(np.float32)
    sel, res = jpar.reshard_elements(s["el"], jnp.asarray(bary), P4,
                                     vertex_layout="owned")
    for r, o in enumerate(ranks):
        tets, parts, n_if = o["fem"]["reshard"]
        np.testing.assert_array_equal(parts, np.asarray(res.parts))
        np.testing.assert_array_equal(tets, np.asarray(sel.tets[r]))
        assert n_if == sel.n_interface


@pytest.mark.parametrize("c", [0.0, 1.0])
def test_element_apply_matches_jax(setup, c):
    """The geometry form of the element pass, on one part's row with its
    padding (pad slot dropped by the scatter)."""
    import torch
    from repro_torch.fem.parallel import element_apply
    sel = setup["sel"]["owned"]
    V = sel.halo.V
    rng = np.random.default_rng(6)
    u = rng.normal(size=V).astype(np.float32)
    want = np.asarray(jpar.element_apply(sel.tets[1], sel.grads[1],
                                         sel.vol[1], jnp.asarray(u), V, c))
    got = element_apply(torch.as_tensor(np.array(sel.tets[1])),
                        torch.as_tensor(np.array(sel.grads[1])),
                        torch.as_tensor(np.array(sel.vol[1])),
                        torch.as_tensor(u), V, c).numpy()
    _close(got, want, "element_apply")


# --- the sharded session ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_session():
    return JF.AdaptiveSession(SESSION_SPECS[0]).run(JF.unit_cube_mesh(3))


@pytest.mark.parametrize("li", [0, 1], ids=["replicated", "owned"])
def test_sharded_session_matches_jax(ranks, jax_session, li):
    """Per-step n_tets, imbalance and repartitions equal to the JAX
    package's sharded session (replicated layout); TotalV equal where the
    partition history is the same.  The owned session partitions step 0
    twice, as the reference's owned solve stage does (the unrefined mesh
    before its solve, then the refined mesh in the balance stage), so its
    step-0 TotalV is checked by the replay below instead."""
    ref = jax_session
    for o in ranks:
        got = o["sessions"][li]
        assert got["n_repartitions"] == ref.n_repartitions
        assert len(got["stats"]) == len(ref.stats)
        for step, (a, b) in enumerate(zip(got["stats"], ref.stats)):
            n_tets, imb, rep, totalv, cut, halo_b, psum_b, err, cg = a
            assert n_tets == b.n_tets
            assert imb == float(b.imbalance)
            assert rep == b.repartitioned
            if li == 0 or step > 0:
                assert totalv == b.migration_totalv
            assert abs(err - b.err_l2) <= 1e-4 * b.err_l2
            if li == 1:
                assert cut is not None and 0 < halo_b < psum_b
        assert got["stats"] == ranks[0]["sessions"][li]["stats"]
        np.testing.assert_array_equal(got["u"], ranks[0]["sessions"][li]["u"])


@pytest.mark.parametrize("li", [0, 1], ids=["replicated", "owned"])
def test_sharded_session_balance_replay(ranks, li):
    """Every balance stage of the port's sharded session, replayed on its
    own input through the JAX package's sharded ``Balancer``: the same
    parts and TotalV, and the migration executor conserved the weight."""
    jb = J.Balancer(SESSION_SPECS[li].balance.replace(backend="sharded"))
    for cap in ranks[0]["sessions"][li]["captured"]:
        if not cap["repartitioned"]:
            continue
        old = (None if cap["inherited"] is None
               else jnp.asarray(cap["inherited"], jnp.int32))
        want = jb.balance(jnp.ones(len(cap["bary"])),
                          coords=jnp.asarray(cap["bary"]), old_parts=old)
        np.testing.assert_array_equal(cap["parts"], np.asarray(want.parts))
        assert cap["total_v"] == float(want.total_v)
        if old is not None:
            mig = cap["migration"]
            assert mig["weight_in"] == mig["weight_out"] == len(cap["bary"])
            assert mig["overflow"] == 0
        # the element packing after the migration holds every element once
        n_real = sum(o["sessions"][li]["captured"][cap["step"]]["sharded_real"]
                     for o in ranks)
        assert n_real == len(cap["bary"])
