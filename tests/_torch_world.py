"""Rank bodies for the multi-rank tests of the port (``tests/test_torch_
distributed.py``, ``tests/test_torch_halo.py``,
``tests/test_torch_serve_sharded.py``).

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


# ---------------------------------------------------------------------------
# test_torch_serve_sharded.py
# ---------------------------------------------------------------------------
# The scenarios of the JAX package's sharded-serving tests
# (tests/test_serve.py), written once against the session API the two
# packages share: ``make(**spec_kw)`` builds a session, ``Request`` is the
# package's request class.  The parent runs them on the JAX package; the
# ranks run them on the port.

SERVE_BASE = dict(slots=8, groups=4, max_seq=64, rebalance_every=1000,
                  prefill="full", decode="sharded", rebalance="kv")


def _outcome(sess, reqs):
    return {"out": [list(r.out) for r in reqs],
            "group": [r.group for r in reqs], "slot": [r.slot for r in reqs],
            "done": [r.done for r in reqs],
            "migrations": [r.migrations for r in reqs],
            "log": [dict(e) for e in sess.migration_log],
            "prefill_stats": dict(sess.prefill_stats),
            "kv_slot_bytes": sess.kv_slot_bytes}


def _run_all(sess, reqs, max_steps):
    for r in reqs:
        sess.submit(r)
    sess.run(max_steps=max_steps)
    return _outcome(sess, reqs)


def _migration_parity(make, Request, prompt):
    """A forced KV-slot migration mid-decode (test_serve.py's
    test_migration_parity_bit_identical), and the same run without it."""
    out = {}
    for migrate in (False, True):
        sess = make()
        r = Request(rid=0, prompt=prompt, max_new=10)
        sess.submit(r)
        stats = None
        for i in range(16):
            sess.step()
            if migrate and i == 3 and not r.done:
                stats = dict(sess.migrate_request(0, dst_group=2))
            if r.done:
                break
        out["mig" if migrate else "ref"] = dict(_outcome(sess, [r]),
                                                stats=stats)
    return out


def _slot_reuse(make, Request, prompt_a, prompt_b):
    """Both ends of a migration reused (test_slot_reuse_after_migration)."""
    def fresh(prompt):
        sess = make(slots=2, groups=2)
        r = Request(rid=9, prompt=prompt, max_new=6)
        return _run_all(sess, [r], 16)

    sess = make(slots=2, groups=2)                      # spg = 1
    a = Request(rid=0, prompt=prompt_a, max_new=12)
    sess.submit(a)
    sess.step()
    seated = a.slot
    stats = dict(sess.migrate_request(0, dst_group=1))
    moved_to = (a.slot, a.group)
    b = Request(rid=1, prompt=prompt_b, max_new=6)
    sess.submit(b)
    sess.run(max_steps=32)
    c = Request(rid=2, prompt=prompt_b, max_new=6)
    d = Request(rid=3, prompt=prompt_a, max_new=6)
    out = _run_all(sess, [c, d], 32)
    return {"seated": seated, "moved_to": moved_to, "stats": stats,
            "ab": _outcome(sess, [a, b]), "cd": out,
            "fresh_a": fresh(prompt_a), "fresh_b": fresh(prompt_b)}


def _kv_rebalance(make, Request, prompts):
    """The session's own rebalances migrate KV
    (test_kv_rebalance_logs_moved_bytes)."""
    reqs = [Request(rid=i, prompt=p, max_new=4 + 4 * (i % 3))
            for i, p in enumerate(prompts)]
    return _run_all(make(rebalance_every=4), reqs, 64)


def _packed_parity(make, Request, prompts, p):
    """Packed against per-request prefill at p groups
    (test_packed_prefill_token_parity)."""
    out = {}
    for mode in ("full", "packed"):
        reqs = [Request(rid=i, prompt=pr, max_new=4)
                for i, pr in enumerate(prompts)]
        out[mode] = _run_all(make(slots=2 * p, groups=p, max_seq=32,
                                  prefill=mode, page_size=4,
                                  rebalance_every=4), reqs, 128)
    return out


def _multi_pack(make, Request, prompts):
    """A buffer smaller than the wave (test_packed_multi_pack_small_
    capacity)."""
    out = {}
    for mode, extra in (("full", {}), ("packed", {"prefill_capacity": 16})):
        reqs = [Request(rid=i, prompt=pr, max_new=3)
                for i, pr in enumerate(prompts)]
        out[mode] = _run_all(make(max_seq=32, prefill=mode, page_size=4,
                                  rebalance="never", **extra), reqs, 64)
    return out


def _deferred(make, Request, prompt_a, prompt_b):
    """A mover whose destination is full is deferred, then retried first
    (test_deferred_move_retry)."""
    import numpy as np
    sess = make(slots=2, groups=2)                      # spg = 1
    a = Request(rid=0, prompt=prompt_a, max_new=12)
    b = Request(rid=1, prompt=prompt_b, max_new=12)
    sess.submit(a)
    sess.submit(b)
    sess.step()
    groups = (a.group, b.group)
    lo, hi = (a, b) if a.group == 0 else (b, a)
    first = sess._plan_moves(sess._live(), np.asarray([1, 1], np.int32))
    kept = dict(sess._deferred_moves)
    sess.active[hi.slot] = None
    second = sess._plan_moves([(lo.slot, lo)], np.asarray([1], np.int32))
    return {"groups": groups, "lo": (lo.rid, lo.slot), "hi_slot": hi.slot,
            "first": first, "kept": kept, "second": second,
            "kept_after": dict(sess._deferred_moves)}


def serve_scenarios(make, Request, prompts, groups):
    """Every sharded-serving scenario at ``groups`` groups; results as
    plain Python values."""
    if groups == 4:
        return {
            "migration_parity": _migration_parity(make, Request,
                                                  prompts["parity"]),
            "kv_rebalance": _kv_rebalance(make, Request, prompts["kv"]),
            "packed_parity": _packed_parity(make, Request, prompts["packed"],
                                            4),
            "multi_pack": _multi_pack(make, Request, prompts["multi"])}
    return {"slot_reuse": _slot_reuse(make, Request, *prompts["pair"]),
            "packed_parity": _packed_parity(make, Request, prompts["packed"],
                                            2),
            "deferred": _deferred(make, Request, *prompts["pair"])}


def _kv_state(arrays, rank, spg):
    from repro_torch.serve import KVCache
    k, v, sp, pos = arrays
    rows = slice(rank * spg, (rank + 1) * spg)
    return KVCache(k=torch.as_tensor(k[:, rows]).clone(),
                   v=torch.as_tensor(v[:, rows]).clone(),
                   stored_pos=torch.as_tensor(sp[rows]).clone(),
                   pos=torch.as_tensor(pos[rows]).clone())


def slot_migrations(comm, cfg, arrays, moves, chunk_bytes):
    """``SlotMigrator`` on this rank's rows of a global state, in one
    chunk (a budget above any send buffer) and in chunks of
    ``chunk_bytes``, with the bytes each put on the all_to_all."""
    from repro_torch.serve import SlotMigrator, slot_axes
    spg = arrays[0].shape[1] // comm.size
    out = {}
    for name, chunk in (("whole", 1 << 62), ("chunked", chunk_bytes)):
        state = _kv_state(arrays, comm.rank, spg)
        mig = SlotMigrator(cfg, comm, slot_axes(cfg), state,
                           chunk_bytes=chunk)
        sent = comm.all_to_all_bytes
        state, stats = mig(state, moves)
        out[name] = {"state": [x.numpy() for x in (state.k, state.v,
                                                    state.stored_pos,
                                                    state.pos)],
                     "stats": stats,
                     "wire_bytes": comm.all_to_all_bytes - sent}
    return out


# the MoE case: sharded decode (a rank's rows, each its own routing
# group) with KV rebalancing, against the replicated session
MOE_SPEC = dict(SERVE_BASE, max_seq=64, rebalance_every=4)


def moe_requests(Request, prompts):
    return [Request(rid=i, prompt=p, max_new=3 + 3 * (i % 4))
            for i, p in enumerate(prompts)]


# the recurrent families (mamba2, recurrentgemma at SMOKE): sharded decode
# with KV rebalancing and a forced migration; prompts of 20-38 tokens wrap
# the hybrid's ring of 32
RECURRENT_SPEC = dict(SERVE_BASE, rebalance_every=4)


def recurrent_prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return {"parity": rng.integers(1, vocab, 36),
            "kv": [rng.integers(1, vocab, 20 + 2 * i) for i in range(10)]}


def recurrent_scenarios(make, Request, prompts):
    return {"migration_parity": _migration_parity(make, Request,
                                                  prompts["parity"]),
            "kv_rebalance": _kv_rebalance(make, Request, prompts["kv"])}


def recurrent_migrations(comm, cfg, arrays, moves):
    """``SlotMigrator`` on this rank's rows of a global SSM / hybrid state
    (``arrays``: its leaves in order), whole and one layer a chunk."""
    from repro_torch.serve import SlotMigrator, init_serve_state, slot_axes
    from repro_torch.serve.slots import _leaves
    axes = _leaves(slot_axes(cfg))
    spg = arrays[0].shape[axes[0]] // comm.size
    mine = slice(comm.rank * spg, (comm.rank + 1) * spg)
    out = {}
    for name, chunk in (("whole", 1 << 62), ("chunked", 1)):
        state = init_serve_state(cfg, spg, 64, device="cpu")
        for leaf, ax, a in zip(_leaves(state), axes, arrays):
            leaf.copy_(torch.as_tensor(a[(slice(None),) * ax + (mine,)]))
        mig = SlotMigrator(cfg, comm, slot_axes(cfg), state,
                           chunk_bytes=chunk)
        sent = comm.all_to_all_bytes
        state, stats = mig(state, moves)
        out[name] = {"state": [x.numpy() for x in _leaves(state)],
                     "stats": stats,
                     "wire_bytes": comm.all_to_all_bytes - sent}
    return out


def recurrent_world(comm, arch, weights, prompts, arrays, moves):
    """A recurrent family's sharded scenarios and its slot migrator."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import model_from_tensors
    from repro_torch.serve import Request, ServeSession, ServeSpec
    cfg = get_smoke(arch)
    model = model_from_tensors(cfg, {k: torch.as_tensor(v)
                                     for k, v in weights.items()})

    def make(**kw):
        spec = ServeSpec(**{**RECURRENT_SPEC, **kw})
        return ServeSession(model, cfg, spec, comm=comm)

    return {"scenarios": recurrent_scenarios(make, Request, prompts),
            "migration": recurrent_migrations(comm, cfg, arrays, moves)}


def serve_world(comm, cfg, weights, prompts, migration_case, moe_case=None,
                recurrent=()):
    """Every scenario of this world's group count on the port's sharded
    session, then (at 4 groups) the slot migrator alone and, with
    ``moe_case`` = (cfg, weights, prompts), an MoE model's session; then
    each case of ``recurrent`` (``recurrent_world``'s arguments), by
    architecture."""
    from repro_torch.models import model_from_tensors
    from repro_torch.serve import Request, ServeSession, ServeSpec
    model = model_from_tensors(cfg, {k: torch.as_tensor(v)
                                     for k, v in weights.items()})

    def make(**kw):
        spec = ServeSpec(**{**SERVE_BASE, **kw})
        return ServeSession(model, cfg, spec, comm=comm)

    out = {"scenarios": serve_scenarios(make, Request, prompts, comm.size)}
    if migration_case is not None:
        out["migration"] = slot_migrations(comm, cfg, *migration_case)
    if moe_case is not None:
        mcfg, mweights, mprompts = moe_case
        moe = model_from_tensors(mcfg, {k: torch.as_tensor(v)
                                        for k, v in mweights.items()})
        sess = ServeSession(moe, mcfg, ServeSpec(**MOE_SPEC), comm=comm)
        out["moe"] = _run_all(sess, moe_requests(Request, mprompts), 128)
    out["recurrent"] = {case[0]: recurrent_world(comm, *case)
                        for case in recurrent}
    return out


# ---------------------------------------------------------------------------
# test_torch_train.py
# ---------------------------------------------------------------------------

def compressed_sums(comm, xs):
    """``train.compressed_psum`` of this rank's row of each (p, ...) array
    of ``xs``."""
    from repro_torch.train import compressed_psum
    return [compressed_psum(torch.as_tensor(x[comm.rank]), comm).numpy()
            for x in xs]
