"""Distributed adaptive FEM over 4 ranks on the PyTorch port.

Runs the paper's compute model through the declarative session API: an
``AdaptSpec`` with ``backend='sharded'`` and ``vertex_layout='owned'``
runs the balance stage as the sharded pipeline (one rank per part of a
``torch.distributed`` group), re-packs the refined mesh's element
payloads across the ranks with the migration executor's ``all_to_all``
after every repartition, and rebuilds the owned-vertex ``HaloPlan`` from
each new partition's cut.  The solve stage then runs distributed PCG
whose matvec communicates by the neighbour halo exchange -- wire volume
proportional to the partition's surface, with no vertex-sized global
sum anywhere.

The final packing is cross-checked two ways: an owned-layout PCG solve
against the session's own solution, and against the replicated-vertex
(global sum) oracle packing of the same mesh.

    PYTHONPATH=src python examples/torch/parallel_fem.py [--device cpu]

The ranks go on the card by default (4 ranks on cuda:0 over gloo), on
4 CPU processes with ``--device cpu``.  ``fem_rank(comm, device)`` is
one rank's body.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core import BalanceSpec
from repro_torch.distributed import run_world
from repro_torch.fem import (AdaptSpec, AdaptiveSession, HelmholtzProblem,
                             build_elements, load_vector, unit_cube_mesh)
from repro_torch.fem.adapt import free_mask
from repro_torch.fem.parallel import (make_sharded_matvec, shard_elements,
                                      sharded_diagonal,
                                      sharded_solve_dirichlet)
from repro_torch.fem.solve import pcg

RANKS = 4


def fem_rank(comm, device, echo=True):
    """One rank: the sharded adaptive session, then the owned-layout
    solve on its final packing against the session's solution and the
    replicated-layout oracle.  Rank 0 prints (with ``echo``); every rank
    returns its lines, per-step stats and the two gaps."""
    p = comm.size
    lines = []

    def say(msg):
        lines.append(msg)
        if echo and comm.rank == 0:
            print(msg, flush=True)

    # the whole adaptive loop as one declarative spec: Dörfler marking,
    # repartition every step, sharded DLB + element migration + halo-plan
    # rebuild on the ranks, owned-vertex distributed PCG
    spec = AdaptSpec(problem="helmholtz", theta=0.4, trigger="always",
                     backend="sharded", vertex_layout="owned",
                     max_steps=4, max_tets=8000, tol=1e-6,
                     balance=BalanceSpec(p=p, method="hsfc"))

    def on_step(stats, state):
        say(f"step {state.step}: tets={stats.n_tets:6d} on {p} ranks  "
            f"cg_iters={stats.cg_iters} err={stats.err_l2:.3e} "
            f"imbalance={stats.imbalance:.3f} "
            f"migrated={stats.migration_totalv:.0f} "
            f"cut={stats.cut} "
            f"halo_bytes={stats.comm_halo_bytes} "
            f"(psum would be {stats.comm_psum_bytes})")

    res = AdaptiveSession(spec, comm=comm, on_step=on_step).run(
        unit_cube_mesh(3))

    # -- distributed solve on the final packing ----------------------------
    # res.sharded is this rank's owned-layout element list that the
    # balance stage migrated (res.halo the matching plan); solve the same
    # Helmholtz system with halo-exchange PCG and check it reproduces the
    # session's solution.
    prob = HelmholtzProblem()
    mesh, sel = res.mesh, res.sharded
    el = build_elements(mesh.verts, mesh.tets, device=device)
    verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=device)
    free = free_mask(mesh, device)
    g = prob.exact(verts)
    # rank 0's load vector on every rank (the card's sums may round
    # differently between ranks)
    rhs = comm.broadcast(load_vector(el, verts, prob.f).contiguous())
    sol = sharded_solve_dirichlet(sel, comm, rhs, g, free, prob.c,
                                  tol=1e-6, maxiter=2000)
    u = sol.x

    # -- replicated-vertex oracle on the same mesh / partition -------------
    # same PCG, but the matvec reduces with the global sum the owned
    # layout replaced; the two distributed solves must agree.
    parts = mesh.leaf_payload["parts"]
    sel_rep = shard_elements(el, parts, p, rank=comm.rank)
    matvec, _ = make_sharded_matvec(sel_rep, comm, c=prob.c)
    diag = sharded_diagonal(sel_rep, comm, prob.c)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    lift = matvec(torch.where(free > 0, zero, g))
    b = torch.where(free > 0, rhs - lift, zero)

    def mv_free(v):
        return torch.where(free > 0, matvec(v * free), v)

    sol_rep = pcg(mv_free, b, torch.where(free > 0, diag, 1.0),
                  torch.zeros_like(b), tol=1e-6, maxiter=2000)
    u_rep = sol_rep.x + torch.where(free > 0, zero, g)

    err = float((u - prob.exact(verts)).abs().max())
    gap_session = float((u - res.u).abs().max())
    gap_rep = float((u - u_rep).abs().max())
    say(f"owned-vertex PCG on final mesh: cg_iters={int(sol.iters)} "
        f"max_err={err:.3e} |u_owned - u_session|_inf={gap_session:.3e} "
        f"|u_owned - u_replicated|_inf={gap_rep:.3e}")
    assert gap_session < 1e-4, f"owned vs session solution gap {gap_session}"
    assert gap_rep < 1e-4, f"owned vs replicated solution gap {gap_rep}"
    return {"lines": lines, "gap_session": gap_session, "gap_rep": gap_rep,
            "cg_iters": int(sol.iters),
            "stats": [(s.n_tets, s.cg_iters, float(s.imbalance), s.cut,
                       s.comm_halo_bytes, s.comm_psum_bytes)
                      for s in res.stats]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    on_cpu = torch.device(args.device).type == "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        return run_world(fem_rank, RANKS, args.device,
                         init_file=os.path.join(tmp, "rendezvous"),
                         devices=[args.device] * RANKS if on_cpu else None,
                         join_s=600.0)


if __name__ == "__main__":
    main()
