"""Rank bodies for the multi-rank tests of the port (``tests/test_torch_
distributed.py``, ``tests/test_torch_halo.py``).

Each function runs on every rank of a gloo world of CPU processes started
by ``repro_torch.distributed.run_world``, takes the shared numpy inputs,
and returns numpy results for the parent, which holds them against the
JAX package.  This module imports no JAX: the ranks are fresh ``spawn``
processes and only need the port.
"""
import numpy as np
import torch

BALANCE_FIELDS = ("parts", "part_weights", "imbalance", "total_v", "max_v",
                  "retained", "remap_perm", "splitters")


def world(fn, *args, tmp_path, p=4):
    """``fn(comm, *args)`` on ``p`` gloo CPU ranks; the ranks' results in
    rank order.  Rendezvous through a file under ``tmp_path``; a hung
    collective fails the test after the join deadline."""
    from repro_torch.distributed import run_world
    init = tmp_path / f"rendezvous-{fn.__name__}"
    return run_world(fn, p, *args, init_file=str(init), devices=["cpu"] * p,
                     timeout_s=60.0, join_s=120.0)


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return x


def result_dict(r):
    out = {f: _np(getattr(r, f)) for f in BALANCE_FIELDS}
    out["ksection_rounds"] = r.ksection_rounds
    out["migration"] = (None if r.migration is None else
                        {k: _np(v) for k, v in r.migration.items()})
    return out


# ---------------------------------------------------------------------------
# test_torch_distributed.py
# ---------------------------------------------------------------------------

def collectives(comm, x, w, dest, pay, valid, capacities, scan_w):
    """The ``Comm`` collectives, the MPI_Scan helpers and the migration
    executor on this rank's shard of the shared inputs."""
    from repro_torch.core import partition1d as p1d
    from repro_torch.distributed import migrate_items
    r, p = comm.rank, comm.size

    def mine(a):
        C = a.shape[0] // p
        return torch.as_tensor(a[r * C:(r + 1) * C])
    xt = mine(x)
    out = {
        "all_gather": comm.all_gather(xt).numpy(),
        "psum": comm.psum(xt).numpy(),
        "pmin": comm.pmin(xt).numpy(),
        "pmax": comm.pmax(xt).numpy(),
        "all_to_all": comm.all_to_all(xt).numpy(),
        "all_to_all_async": comm.all_to_all_async(xt * 2).wait().numpy(),
        "broadcast": comm.broadcast(xt + r).numpy(),
        "scan_over_axis": p1d.exclusive_scan_over_axis(
            mine(scan_w).sum(), comm).numpy(),
        "prefix_parts": p1d.distributed_prefix_parts(
            mine(scan_w), p, comm).numpy(),
        "staged_bytes": comm.staged_bytes,
    }
    out["migrate"] = []
    for cap in capacities:
        m = migrate_items({"x": mine(pay), "id": mine(np.arange(len(dest)))},
                          mine(dest), mine(w), comm, p, valid=mine(valid),
                          capacity=cap)
        out["migrate"].append({
            "x": m.payload["x"].numpy(), "id": m.payload["id"].numpy(),
            "weights": m.weights.numpy(), "valid": m.valid.numpy(),
            **{k: float(getattr(m, k)) for k in (
                "n_recv", "overflow", "w_sent", "w_received", "w_kept")}})
    return out


def collectives_and_balances(comm, coll_args, bal_args):
    return {"collectives": collectives(comm, *coll_args),
            "balances": balances(comm, *bal_args)}


def device_of(comm):
    return str(comm.device)


def fail_on_rank_1(comm):
    if comm.rank == 1:
        raise ValueError("rank 1 stops here")
    return comm.rank


def balances(comm, coords, w, old, cases):
    """Sharded ``Balancer`` runs: ``cases`` are (spec dict, use_old,
    warm) -- ``warm`` threads each call's splitters into a second call."""
    from repro_torch.core import Balancer, BalanceSpec
    out = []
    for spec_d, use_old, warm in cases:
        b = Balancer(BalanceSpec.from_dict(spec_d), comm=comm)
        kw = dict(coords=None if coords is None else torch.as_tensor(coords),
                  old_parts=torch.as_tensor(old) if use_old else None)
        r = b.balance(torch.as_tensor(w), **kw)
        if warm:
            r = b.balance(torch.as_tensor(w), warm_splitters=r.splitters,
                          **kw)
        res = result_dict(r)
        # this rank's shard of the pipeline, straight from balance_fn
        res["rank_parts"] = _np(b.balance_fn(
            *_shard_inputs(b, w, coords, old if use_old else None,
                           comm)).parts)
        out.append(res)
    return out


def _shard_inputs(b, w, coords, old, comm):
    wt, xyz, ot, _, n = b._pad(torch.as_tensor(w),
                               None if coords is None
                               else torch.as_tensor(coords),
                               None if old is None else torch.as_tensor(old))
    C = wt.shape[0] // comm.size
    sl = slice(comm.rank * C, (comm.rank + 1) * C)
    return (wt[sl], xyz[sl]) + (() if ot is None else (ot[sl],))


# ---------------------------------------------------------------------------
# test_torch_halo.py
# ---------------------------------------------------------------------------

def fem_operators(comm, mesh_d, parts, u, c, rhs, free, g, sel_rows):
    """Packers, the replicated / owned matvec (with and without overlap),
    the diagonals and the owned PCG on this rank."""
    from repro_torch import interop
    from repro_torch.fem import build_elements
    from repro_torch.fem import parallel as par
    from repro_torch.fem.halo import build_halo_plan
    r, p = comm.rank, comm.size
    el = build_elements(mesh_d["verts"], mesh_d["tets"], device="cpu")
    plan = build_halo_plan(mesh_d["tets"], parts, el.n_verts, p)
    out = {}
    for name, halo in (("replicated", None), ("owned", plan)):
        dev_pack = par.shard_elements_on_device(el, parts, p, comm, halo=halo)
        host_pack = par.shard_elements(el, parts, p, halo, rank=r)
        out[name + "_pack"] = {
            "device": [dev_pack.tets.numpy(), dev_pack.grads.numpy(),
                       dev_pack.vol.numpy(), dev_pack.n_interface],
            "host": [host_pack.tets.numpy(), host_pack.grads.numpy(),
                     host_pack.vol.numpy(), host_pack.n_interface]}
    # the JAX package's host packing of this rank, converted
    sel_rep = interop.sharded_elements_from_jax(sel_rows["replicated"], r)
    sel_own = interop.sharded_elements_from_jax(sel_rows["owned"], r)
    ut = torch.as_tensor(u)
    mv, _ = par.make_sharded_matvec(sel_rep, comm, c)
    out["rep_matvec"] = mv(ut).numpy()
    out["rep_diag"] = par.sharded_diagonal(sel_rep, comm, c).numpy()
    ul = sel_own.halo.to_local(ut, r)
    for overlap in (False, True):
        mv, _ = par.make_sharded_matvec(sel_own, comm, c, overlap=overlap)
        y = mv(ul)
        out[f"own_matvec_{overlap}"] = y.numpy()
        out[f"own_matvec_global_{overlap}"] = (
            sel_own.halo.from_local(y, comm).numpy())
    out["own_diag"] = sel_own.halo.from_local(
        par.sharded_diagonal(sel_own, comm, c), comm).numpy()
    for overlap in (False, True):
        sol = par.sharded_solve_dirichlet(
            sel_own, comm, torch.as_tensor(rhs), torch.as_tensor(g),
            torch.as_tensor(free), c, tol=1e-6, overlap=overlap)
        out[f"own_solve_{overlap}"] = (sol.x.numpy(), int(sol.iters))
    t_if, t_int = par.measure_matvec_phases(sel_own, comm, c)
    out["phases_ok"] = t_if >= 0.0 and t_int >= 0.0
    sel, res = par.reshard_elements(el, torch.as_tensor(mesh_d["bary"]), p,
                                    comm, vertex_layout="owned")
    out["reshard"] = (sel.tets.numpy(), res.parts.numpy(), sel.n_interface)
    return out


def fem_and_sessions(comm, fem_args, session_args):
    return {"fem": fem_operators(comm, *fem_args),
            "sessions": sessions(comm, *session_args)}


def sessions(comm, mesh_d, spec_dicts):
    """Sharded sessions; each balance stage's input mesh (barycenters,
    inherited parts) and output are captured for a replay."""
    from repro_torch import interop
    from repro_torch.fem import AdaptSpec, AdaptiveSession
    out = []
    for spec_d in spec_dicts:
        sess = AdaptiveSession(AdaptSpec.from_dict(spec_d), comm=comm)
        stage = sess._stages["balance"]
        captured = []

        def balance_and_capture(session, state, stage=stage,
                                captured=captured):
            inherited = state.mesh.leaf_payload.get("parts")
            if inherited is not None and len(inherited) != state.mesh.n_tets:
                inherited = None
            bary = state.mesh.barycenters().astype(np.float32)
            stage(session, state)
            mig = (state.balance_result.migration
                   if state.repartitioned and state.balance_result else None)
            captured.append({
                "step": state.step, "bary": bary,
                "inherited": None if inherited is None
                else np.array(inherited),
                "parts": np.array(state.mesh.leaf_payload["parts"]),
                "repartitioned": state.repartitioned,
                "total_v": state.migration_totalv,
                "migration": None if mig is None
                else {k: float(v) for k, v in mig.items()},
                "sharded_rows": int(state.sharded.vol.shape[0]),
                "sharded_real": int((state.sharded.vol > 0).sum())})
        sess._stages["balance"] = balance_and_capture
        res = sess.run(interop.mesh_from_numpy(mesh_d))
        out.append({
            "stats": [(s.n_tets, float(s.imbalance), s.repartitioned,
                       float(s.migration_totalv), s.cut, s.comm_halo_bytes,
                       s.comm_psum_bytes, float(s.err_l2), s.cg_iters)
                      for s in res.stats],
            "n_repartitions": res.n_repartitions,
            "captured": captured, "u": res.u.numpy()})
    return out
