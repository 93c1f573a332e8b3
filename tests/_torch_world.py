"""Rank bodies for the multi-rank tests of the port (``tests/test_torch_
distributed.py``, ``tests/test_torch_halo.py``,
``tests/test_torch_serve_sharded.py``, ``tests/test_torch_train.py``,
``tests/test_torch_train_dp.py``).

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
    """``SlotMigrator`` on this rank's rows of a global SSM / hybrid /
    encoder-decoder / VLM state (``arrays``: its leaves in order), whole
    and one layer a chunk.  The rows start from the family's empty state
    (the dry-run state for the encoder-decoder, which has no empty one)."""
    from repro_torch.serve import SlotMigrator, slot_axes
    from repro_torch.serve.decode import init_decode_state, init_serve_state
    from repro_torch.serve.slots import _leaves
    axes = _leaves(slot_axes(cfg))
    spg = arrays[0].shape[axes[0]] // comm.size
    mine = slice(comm.rank * spg, (comm.rank + 1) * spg)
    init = init_decode_state if cfg.family == "encdec" else init_serve_state
    out = {}
    for name, chunk in (("whole", 1 << 62), ("chunked", 1)):
        state = init(cfg, spg, 64, device="cpu")
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


# the session spec of each family's sharded case: whisper is served with
# the cheap prefill (the reference's only engine path for it), qwen2-vl
# with the full prefill (packed is refused for M-RoPE)
FAMILY_SPEC = {"whisper_medium": dict(RECURRENT_SPEC, prefill="cheap"),
               "qwen2_vl_72b": RECURRENT_SPEC}


def _family_world(comm, arch, weights, prompts, arrays, moves):
    """A family's sharded scenarios and its slot migrator at SMOKE."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import model_from_tensors
    from repro_torch.serve import Request, ServeSession, ServeSpec
    cfg = get_smoke(arch)
    model = model_from_tensors(cfg, {k: torch.as_tensor(v)
                                     for k, v in weights.items()})
    base = FAMILY_SPEC.get(arch, RECURRENT_SPEC)

    def make(**kw):
        spec = ServeSpec(**{**base, **kw})
        return ServeSession(model, cfg, spec, comm=comm)

    return {"scenarios": recurrent_scenarios(make, Request, prompts),
            "migration": recurrent_migrations(comm, cfg, arrays, moves)}


def recurrent_world(comm, arch, weights, prompts, arrays, moves):
    """A recurrent family's (mamba2, recurrentgemma) sharded scenarios and
    its slot migrator."""
    return _family_world(comm, arch, weights, prompts, arrays, moves)


def encdec_world(comm, weights, prompts, arrays, moves):
    """whisper-medium SMOKE: sharded decode after the cheap prefill (zero
    cross K/V), KV rebalancing, a forced migration; the migrator ships
    the self-attention cache and ``cross_k`` / ``cross_v`` on slot axis
    1."""
    return _family_world(comm, "whisper_medium", weights, prompts, arrays,
                         moves)


def vlm_world(comm, weights, prompts, arrays, moves):
    """qwen2-vl-72b SMOKE: sharded decode after the full prefill (M-RoPE
    over text positions), KV rebalancing, a forced migration."""
    return _family_world(comm, "qwen2_vl_72b", weights, prompts, arrays,
                         moves)


def serve_world(comm, cfg, weights, prompts, migration_case, moe_case=None,
                recurrent=(), encdec=None, vlm=None):
    """Every scenario of this world's group count on the port's sharded
    session, then (at 4 groups) the slot migrator alone and, with
    ``moe_case`` = (cfg, weights, prompts), an MoE model's session; then
    each case of ``recurrent`` (``recurrent_world``'s arguments), by
    architecture, and the ``encdec`` and ``vlm`` cases (the arguments of
    ``encdec_world`` and ``vlm_world``)."""
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
    if encdec is not None:
        out["encdec"] = encdec_world(comm, *encdec)
    if vlm is not None:
        out["vlm"] = vlm_world(comm, *vlm)
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


# ---------------------------------------------------------------------------
# test_torch_train_dp.py
# ---------------------------------------------------------------------------

DP_OPT = dict(lr=1e-3, warmup=1, total_steps=10)


def _np_dict(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _gather_moments(state, model, ocfg, shards, data):
    """Whole moments on every rank from each rank's part (a collective:
    every rank of ``data`` calls it)."""
    from repro_torch.train import OptState
    from repro_torch.train.optimizer import gather_moment
    dt = getattr(torch, ocfg.adam_dtype)
    return OptState(state.step, *(
        {n: gather_moment(d.get(n), p, shards[n], data, dt)
         for n, p in model.named_parameters()} for d in (state.m, state.v)))


def _shard_moments(full, shards, rank):
    """This rank's part of whole moments (copies)."""
    from repro_torch.train import OptState
    from repro_torch.train.optimizer import _local

    def part(d):
        return {n: _local(t, shards[n]).clone() for n, t in d.items()
                if shards[n].mine(rank)}
    return OptState(full.step, part(full.m), part(full.v))


def model_from_numpy(cfg, weights):
    """A CPU model of ``cfg`` holding copies of ``weights`` (numpy, by
    parameter name)."""
    from repro_torch.models import init_model
    model = init_model(cfg, seed=None, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(weights[n]))
    return model


def _dp_case(comm, arch, overrides, batches, weights):
    """One SMOKE config trained data-parallel on this rank's rows of each
    global batch of ``batches``: the losses and summed gradients of the
    first step's forward, then two steps of the ZeRO update, then two
    with ``compress=True``, each from ``weights``."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import data_shards, rows_of
    from repro_torch.models import loss_fn
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.train_step import sum_grads
    cfg = get_smoke(arch).replace(**overrides)
    ocfg = AdamWConfig(**DP_OPT)
    model = model_from_numpy(cfg, weights)
    first = {k: torch.as_tensor(v) for k, v in rows_of(batches[0],
                                                         comm).items()}
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    term = loss_fn(model, first, cfg, data=comm)
    grads = dict(zip(names, torch.autograd.grad(term, params)))
    sum_grads(grads, comm)
    term = term.detach()
    out = {"term": float(term), "loss": float(comm.psum(term)),
           "grads": _np_dict(grads)}
    for compress in (False, True):
        model = model_from_numpy(cfg, weights)
        shards = data_shards(cfg, model, comm)
        opt = init_opt_state(model, ocfg, shards, comm.rank)
        step = make_train_step(cfg, ocfg, compress=compress, data=comm,
                               shards=shards)
        comp, steps = None, []
        for hb in batches[:2]:
            tb = {k: torch.as_tensor(v) for k, v in rows_of(hb, comm).items()}
            used = {}
            if compress:
                model, opt, comp, m = step(model, opt, tb, comp,
                                           grads_out=used)
            else:
                model, opt, m = step(model, opt, tb, grads_out=used)
            steps.append({"grads": _np_dict(used),
                          "params": _np_dict(dict(model.named_parameters())),
                          "loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                          "reduce_bytes": m["reduce_bytes"],
                          "gather_bytes": m["gather_bytes"]})
        whole = _gather_moments(opt, model, ocfg, shards, comm)
        out["compress" if compress else "zero"] = {
            "steps": steps, "m": _np_dict(whole.m), "v": _np_dict(whole.v),
            "local_m": {n: tuple(t.shape) for n, t in opt.m.items()},
            "shards": {n: (s.dim, s.start, s.size, s.owner)
                       for n, s in shards.items()}}
    return out


def _continue(cfg, ocfg, state, batches, data):
    """Two steps from a whole state held in memory (``state``: params,
    m, v as numpy, and the step), data-parallel over ``data`` (None: one
    rank): the continuation a resumed run must reproduce."""
    from repro_torch.launch.train import data_shards, rows_of
    from repro_torch.train import OptState, make_train_step
    model = model_from_numpy(cfg, state["params"])
    full = OptState(state["step"],
                    {n: torch.as_tensor(a).clone() for n, a in
                     state["m"].items()},
                    {n: torch.as_tensor(a).clone() for n, a in
                     state["v"].items()})
    shards = data_shards(cfg, model, data)
    opt = full if data is None else _shard_moments(full, shards, data.rank)
    step = make_train_step(cfg, ocfg, data=data, shards=shards)
    used = []
    for hb in batches[:2]:
        g = {}
        model, opt, _ = step(model, opt, {k: torch.as_tensor(v) for k, v in
                                          rows_of(hb, data).items()},
                             grads_out=g)
        used.append(_np_dict(g))
    return _np_dict(dict(model.named_parameters())), used


def _elastic(comm, batches, ckpt):
    """Train llama SMOKE at D = 4 for 2 steps with a checkpoint after the
    second; resume it at D = 1 (rank 0) and at D = 2 (ranks 0 and 1) for
    2 more steps, beside the same 2 steps from the D = 4 run's own state
    held in memory."""
    import os
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.distributed import Comm
    from repro_torch.launch.train import data_shards, train
    from repro_torch.models import init_model
    from repro_torch.train import AdamWConfig, restore_sharded
    cfg = get_smoke("llama3_8b")
    kw = dict(seq=64, batch=8, lr=1e-3, device="cpu", log=lambda *a: None)
    first = train(cfg, steps=2, ckpt=os.path.join(ckpt, "d4"), ckpt_every=2,
                  batches=iter(batches), data=comm, **kw)
    whole = _gather_moments(first["opt"], first["model"],
                           AdamWConfig(**DP_OPT),
                           data_shards(cfg, first["model"], comm), comm)
    saved = {"params": _np_dict(dict(first["model"].named_parameters())),
             "m": _np_dict(whole.m), "v": _np_dict(whole.v), "step": 2}
    ocfg = AdamWConfig(lr=1e-3, warmup=1, total_steps=4)
    group = dist.new_group([0, 1])               # every rank calls it
    pair = Comm(group=group, device="cpu") if comm.rank < 2 else None
    out = {"saved": saved}
    for d, sub in ((1, None), (2, pair)):
        if comm.rank >= d:
            continue
        dst = os.path.join(ckpt, f"d{d}")
        if comm.rank == 0:
            shutil.copytree(os.path.join(ckpt, "d4"), dst)
        res = {}
        if sub is not None:
            sub.barrier()
            # the moments as this rank of 2 restores them
            model = init_model(cfg, seed=None, device="cpu")
            _, opt = restore_sharded(dst, model, ocfg,
                                     data_shards(cfg, model, sub), sub.rank)
            res["restored_m"] = _np_dict(opt.m)
            res["shards"] = {n: (s.dim, s.start, s.size, s.owner) for n, s in
                             data_shards(cfg, model, sub).items()}
        resumed = train(cfg, steps=4, ckpt=dst, ckpt_every=100,
                        batches=iter(batches), data=sub, **kw)
        params, used = _continue(cfg, ocfg, saved, batches, sub)
        res.update(start=resumed["start"],
                   params=_np_dict(dict(resumed["model"].named_parameters())),
                   memory_params=params, memory_grads=used)
        out[d] = res
    comm.barrier()
    return out


def _mesh_2x2_case(comm, batch, weights):
    """llama SMOKE on a 2x2 mesh: this rank's ``data_shards`` of its
    model slices, the shapes of its moments, and the clip norm of the
    gradients summed over the data group (``_global_norm`` over the model
    group)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import data_shards, rows_of
    from repro_torch.models import loss_fn
    from repro_torch.train import AdamWConfig, init_opt_state
    from repro_torch.train.optimizer import _global_norm
    from repro_torch.train.train_step import sum_grads
    cfg = get_smoke("llama3_8b")
    mesh = make_mesh(comm, 2, 2)
    lm, slices = sliced_model(cfg, weights, mesh)
    shards = data_shards(cfg, lm, mesh.data, 2)
    opt = init_opt_state(lm, AdamWConfig(**DP_OPT), shards, mesh.data.rank)
    lm.requires_grad_(True)
    names, params = zip(*lm.named_parameters())
    tb = {k: torch.as_tensor(v) for k, v in rows_of(batch, mesh.data).items()}
    loss = loss_fn(lm, tb, cfg, data=mesh.data, model=mesh.model)
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    sum_grads(grads, mesh.data)
    split = frozenset(n for n, sl in slices.items() if sl is not None)
    return {"gnorm": float(_global_norm(grads, mesh.model, split)),
            "shards": {n: (s.dim, s.start, s.size, s.owner)
                       for n, s in shards.items()},
            "slices": {n: None if sl is None else tuple(sl)
                       for n, sl in slices.items()},
            "local": {n: tuple(p.shape) for n, p in zip(names, params)},
            "local_m": {n: tuple(t.shape) for n, t in opt.m.items()},
            "coords": (mesh.data.rank, mesh.model.rank)}


def dp_world(comm, cases, elastic_batches, ckpt, mesh_case):
    """The data-parallel training cases (``(arch, overrides, global
    batches, weights)`` each), the elastic checkpoint (llama SMOKE) and
    llama SMOKE's ZeRO shards and clip norm on a 2x2 mesh (``(batch,
    weights)``)."""
    out = {arch: _dp_case(comm, arch, overrides, batches, weights)
           for arch, overrides, batches, weights in cases}
    out["elastic"] = _elastic(comm, elastic_batches, ckpt)
    out["mesh_2x2"] = _mesh_2x2_case(comm, *mesh_case)
    return out


# ---------------------------------------------------------------------------
# test_torch_tp.py, test_torch_ep.py, test_torch_checkpoint.py: the model
# axis
# ---------------------------------------------------------------------------

def sub_world(comm, size):
    """A ``Comm`` of this rank's block of ``size`` consecutive ranks: the
    world split into ``comm.size // size`` such blocks (every rank
    creates every block's group, in order)."""
    import torch.distributed as dist
    from repro_torch.distributed import Comm
    if size == comm.size:
        return comm
    mine = None
    for first in range(0, comm.size, size):
        g = dist.new_group(list(range(first, first + size)))
        if first <= comm.rank < first + size:
            mine = g
    return Comm(mine, device=comm.device)


def layout_rules(cfg, m, layout):
    """The launcher's rules on a model axis of ``m`` (``layout``
    "head_dim": the reference's, head_dim on "model" at SMOKE), or the
    same with the heads on "model" instead ("heads")."""
    from repro_torch.launch.mesh import train_rules
    rules = train_rules(cfg, m)
    if layout == "heads":
        rules.update(heads="model", head_dim=None)
    return rules


def sliced_model(cfg, weights, mesh, rules=None):
    """A CPU model of ``cfg`` holding this model rank's slices (under
    ``rules``, default ``train_rules``) of ``weights`` (numpy, by
    parameter name): (model, slices)."""
    from repro_torch.distributed.sharding import model_slices, narrow
    from repro_torch.launch.mesh import train_rules
    from repro_torch.models import init_model
    m = 1 if mesh.model is None else mesh.model.size
    i = 0 if mesh.model is None else mesh.model.rank
    rules = train_rules(cfg, m) if rules is None else rules
    slices = model_slices(cfg, rules, m, i)
    lm = init_model(cfg, seed=None, device="cpu", slices=slices)
    with torch.no_grad():
        for n, p in lm.named_parameters():
            p.copy_(narrow(torch.as_tensor(weights[n]), slices[n]))
    return lm, slices


def whole_grads(grads, slices, model):
    """Each gradient in the one-rank layout: a slice's all-gathered over
    the model group (a collective)."""
    from repro_torch.distributed.sharding import unslice
    return {n: unslice(g, slices[n], model).numpy().copy()
            for n, g in grads.items()}


def _tp_case(comm, arch, overrides, d, m, layout, batch, weights):
    """This rank's loss and gradients of one SMOKE config on a (d, m)
    mesh of the first ``d m`` ranks' blocks, the attention in ``layout``
    (``layout_rules``): the global loss, the gradients summed over the
    data group and gathered to the one-rank layout, and this rank's own
    (local) gradients."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import rows_of
    from repro_torch.models import loss_fn
    from repro_torch.train.train_step import sum_grads
    cfg = get_smoke(arch).replace(**overrides)
    mesh = make_mesh(sub_world(comm, d * m), d, m)
    lm, slices = sliced_model(cfg, weights, mesh,
                              layout_rules(cfg, m, layout))
    lm.requires_grad_(True)
    names, params = zip(*lm.named_parameters())
    tb = {k: torch.as_tensor(v) for k, v in rows_of(batch, mesh.data).items()}
    loss = loss_fn(lm, tb, cfg, data=mesh.data, model=mesh.model)
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    loss = loss.detach()
    if mesh.data is not None:
        sum_grads(grads, mesh.data)
        loss = mesh.data.psum(loss)
    return {"loss": float(loss), "local": _np_dict(grads),
            "whole": whole_grads(grads, slices, mesh.model),
            "sliced": sorted(n for n, s in slices.items() if s is not None),
            "coords": (None if mesh.data is None else mesh.data.rank,
                       None if mesh.model is None else mesh.model.rank)}


def _launcher_step(comm, batches):
    """One launcher step of llama SMOKE at 2x2 from the seed-0 init: the
    parameters after it in the one-rank layout."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import model_slices
    from repro_torch.launch.mesh import make_mesh, train_rules
    from repro_torch.launch.train import train
    cfg = get_smoke("llama3_8b")
    mesh = make_mesh(comm, 2, 2)
    out = train(cfg, steps=1, batch=4, seq=64, lr=1e-3, ckpt=None,
                device="cpu", batches=iter(batches), data=mesh.data,
                model=mesh.model, log=lambda *a: None)
    slices = model_slices(cfg, train_rules(cfg, 2), 2, mesh.model.rank)
    params = dict(out["model"].named_parameters())
    return {"params": whole_grads({n: p.detach() for n, p in
                                   params.items()}, slices, mesh.model),
            "history": out["history"]}


def _vocab_parallel_ce(comm, x, head, labels):
    """``layers.chunked_cross_entropy`` of llama SMOKE's widths with the
    head's vocab columns over a model axis of ``comm``'s ranks: the loss
    and its gradients with respect to ``x`` and the head (the one-rank
    layout)."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import Slice, unslice
    from repro_torch.models.layers import chunked_cross_entropy
    cfg = get_smoke("llama3_8b")
    n = head.shape[1] // comm.size
    sl = Slice(1, comm.rank * n, n)
    xt = torch.as_tensor(x).requires_grad_(True)
    ht = torch.as_tensor(head).narrow(*sl).clone().requires_grad_(True)
    loss = chunked_cross_entropy(ht, xt, torch.as_tensor(labels), cfg,
                                 model=comm)
    gx, gh = torch.autograd.grad(loss, (xt, ht))
    return {"loss": float(loss), "grad_x": gx.numpy(),
            "grad_head": unslice(gh, sl, comm).numpy()}


def tp_world(comm, cases, launcher_batches, ce_case):
    """The TP cases (``key: (arch, overrides, d, m, batch, weights)``),
    one launcher step at 2x2 and the vocab-parallel
    ``chunked_cross_entropy`` (``(x, head, labels)``) over 4 ranks."""
    out = {key: _tp_case(comm, *case) for key, case in cases.items()}
    out["launcher"] = _launcher_step(comm, launcher_batches)
    out["chunked_ce"] = _vocab_parallel_ce(comm, *ce_case)
    return out


def _ep_case(comm, cfg_kw, rules, x, weights):
    """The MoE layer of ``ModelConfig(**cfg_kw)`` on a 1 x size mesh
    under ``rules``: its output and the gradients of ``sum(out^2)`` and
    of the aux loss, each in the one-rank layout."""
    from repro_torch.distributed.sharding import model_slices, narrow
    from repro_torch.models import ModelConfig
    from repro_torch.models.moe import MoE, moe_apply
    from repro_torch.models.layers import building
    cfg = ModelConfig(**cfg_kw)
    shapes = {n: tuple(np.shape(w)) for n, w in weights.items()}
    names = ["layers.0.moe." + n for n in shapes]
    full = model_slices(cfg, rules, comm.size, comm.rank,
                        {n: shapes[n.split(".")[-1]] for n in names})
    slices = {n.split(".")[-1]: s for n, s in full.items()}
    parts = iter(slices[n] for n in ("router", "wi", "wg", "wo"))
    with building(lambda w: torch.nn.Parameter(
            narrow(w, next(parts)).clone(), requires_grad=False)):
        moe = MoE(cfg, "cpu")
    with torch.no_grad():
        for n, p in moe.named_parameters():
            p.copy_(narrow(torch.as_tensor(weights[n]), slices[n]))
    moe.requires_grad_(True)
    xt = torch.as_tensor(x)
    names, params = zip(*moe.named_parameters())
    out, aux = moe_apply(moe, xt, cfg, model=comm)
    g_out = torch.autograd.grad(torch.sum(out ** 2), params,
                                retain_graph=True)
    g_aux = torch.autograd.grad(aux, params, allow_unused=True)
    g_aux = [torch.zeros_like(p) if g is None else g
             for g, p in zip(g_aux, params)]
    return {"out": out.detach().numpy(), "aux": float(aux),
            "grad_out": whole_grads(dict(zip(names, g_out)), slices, comm),
            "grad_aux": whole_grads(dict(zip(names, g_aux)), slices, comm),
            "local_rows": tuple(moe.wi.shape)}


def ep_world(comm, cases):
    """The MoE layer cases (``key: (cfg kwargs, rules, x, weights)``)."""
    return {key: _ep_case(comm, *case) for key, case in cases.items()}


def elastic_mesh(comm, batches, ckpt):
    """llama SMOKE trained 2 steps at 2x2 with a checkpoint after the
    second, then the checkpoint carried 2x2 -> 4x1 -> 1x1 -> 2x2: at each
    mesh every rank restores its part (``restore_sharded``; ``restore``
    at 1x1) and the mesh saves it again under a directory of its own
    (step 2); then a run resumed at 4x1, and one at 1x1, takes the third
    step.  Returns the directories and the resumed runs' first steps."""
    import os

    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import model_slices
    from repro_torch.launch.mesh import make_mesh, train_rules
    from repro_torch.launch.train import data_shards, train
    from repro_torch.models import init_model
    from repro_torch.train import (AdamWConfig, init_opt_state, restore,
                                   restore_sharded, save, save_sharded)
    cfg = get_smoke("llama3_8b")
    kw = dict(batch=4, seq=64, lr=1e-3, device="cpu", log=lambda *a: None)
    ocfg = AdamWConfig(lr=1e-3, warmup=1, total_steps=2)
    dirs = {k: os.path.join(ckpt, k) for k in ("2x2", "4x1", "1x1", "2x2b")}
    first = make_mesh(comm, 2, 2)
    train(cfg, steps=2, ckpt=dirs["2x2"], ckpt_every=2,
          batches=iter(batches), data=first.data, model=first.model, **kw)
    for src, dst, (d, m) in (("2x2", "4x1", (4, 1)), ("1x1", "2x2b", (2, 2))):
        mesh = first if (d, m) == (2, 2) else make_mesh(comm, d, m)
        slices = (None if mesh.model is None else
                  model_slices(cfg, train_rules(cfg, m), m, mesh.model.rank))
        lm = init_model(cfg, seed=None, device="cpu", slices=slices)
        shards = data_shards(cfg, lm, mesh.data, m)
        step, opt = restore_sharded(dirs[src], lm, ocfg, shards,
                                    mesh.data.rank, slices=slices)
        save_sharded(dirs[dst], step, lm, opt, ocfg, shards, mesh.data,
                     model=mesh.model, slices=slices)
        if dst == "4x1" and comm.rank == 0:
            lm = init_model(cfg, seed=None, device="cpu")
            step, state = restore(dirs["4x1"], template={
                "params": lm, "opt": init_opt_state(lm, ocfg)})
            save(dirs["1x1"], step, state)
        comm.barrier()
    resumed = {}
    for d, data in ((4, comm), (1, None)):
        if data is None and comm.rank != 0:
            continue
        out = train(cfg, steps=3, ckpt=dirs["2x2"], ckpt_every=100,
                    batches=iter(batches[2:]), data=data, **kw)
        resumed[d] = {"start": out["start"],
                      "params": _np_dict(dict(out["model"]
                                              .named_parameters()))}
    comm.barrier()
    return {"dirs": dirs, "resumed": resumed}


# ---------------------------------------------------------------------------
# test_torch_model_axis.py: the head_dim layout, the RG-LRU on a slice and
# the hybrid's elastic checkpoint
# ---------------------------------------------------------------------------

#: the dim of each attention weight the head_dim rule puts on "model"
HEAD_DIM_OF = {"wq": 2, "wk": 2, "wv": 2, "wo": 1}
#: the dim of each RG-LRU leaf the "mlp" rule puts on "model" (None: the
#: leaf is replicated)
RGLRU_DIM_OF = {"in_x": 1, "in_gate": 1, "conv_w": 0, "conv_b": 0, "w_r": 0,
                "w_i": 0, "b_r": None, "b_i": None, "lam": None, "out": 0}
#: the leaves the RG-LRU's gates read
GATE_LEAVES = ("w_r", "b_r", "w_i", "b_i", "lam")


def _sliced_module(module, weights, dims, model):
    """``module`` holding this model rank's block of each of ``weights``
    along ``dims[name]`` (None: whole), trainable: (module, slices)."""
    from repro_torch.distributed.sharding import Slice, narrow
    slices = {}
    for n, w in weights.items():
        dim = dims[n]
        size = None if dim is None else w.shape[dim] // model.size
        slices[n] = (None if dim is None
                     else Slice(dim, model.rank * size, size))
        setattr(module, n, torch.nn.Parameter(
            narrow(torch.as_tensor(w), slices[n]).clone()))
    return module, slices


def _attention_case(comm, arch, overrides, m, inputs, weights):
    """One attention layer of ``arch``'s SMOKE config in the head_dim
    layout on a model group of ``m`` ranks: its output and the gradients
    of ``sum(y * r)`` with respect to x (and ``enc``, whose K/V the layer
    projects as the encoder-decoder's cross-attention does) and to each
    weight, in the one-rank layout."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.layers import (Attention, attention_apply,
                                           copy_to_model, project_heads)
    cfg = get_smoke(arch).replace(**overrides)
    model = sub_world(comm, m)
    attn, slices = _sliced_module(Attention(cfg, "cpu"), weights,
                                  HEAD_DIM_OF, model)
    x = torch.as_tensor(inputs["x"]).requires_grad_(True)
    pos = torch.as_tensor(inputs["pos"])
    leaves = {"x": x}
    if "enc" in inputs:
        enc = torch.as_tensor(inputs["enc"]).requires_grad_(True)
        leaves["enc"] = enc
        e = copy_to_model(enc, model)
        kv = (project_heads(e, attn.wk, cfg.act_dtype),
              project_heads(e, attn.wv, cfg.act_dtype))
        y = attention_apply(attn, x, cfg, pos=pos, causal=False,
                            kv_override=kv, model=model)
    else:
        pos3 = inputs.get("pos3")
        y = attention_apply(attn, x, cfg, pos=pos, causal=True,
                            pos3=None if pos3 is None
                            else torch.as_tensor(pos3), model=model)
    leaves.update(dict(attn.named_parameters()))
    names, ts = zip(*leaves.items())
    grads = torch.autograd.grad(torch.sum(y * torch.as_tensor(inputs["r"])),
                                ts)
    return {"y": y.detach().numpy(),
            "grads": whole_grads(dict(zip(names, grads)),
                                 {**slices, "x": None, "enc": None}, model)}


def _rglru_case(comm, m, inputs, weights):
    """recurrentgemma SMOKE's RG-LRU block on a model group of ``m``
    ranks (this rank's channels): the block's output and the gradients
    of ``sum(y * r)``; then ``_gates`` alone on the rank's channels of
    ``xc``, its two outputs gathered whole and the gradients of
    ``sum(a * ra + b * rb)``; each gradient in the one-rank layout."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import Slice, narrow, unslice
    from repro_torch.models.rglru import RGLRU, _gates, rglru_block_apply
    cfg = get_smoke("recurrentgemma_2b")
    model = sub_world(comm, m)
    block, slices = _sliced_module(RGLRU(cfg, "cpu"), weights, RGLRU_DIM_OF,
                                   model)
    names, params = zip(*block.named_parameters())
    x = torch.as_tensor(inputs["x"]).requires_grad_(True)
    y = rglru_block_apply(block, x, cfg, model=model)
    g = torch.autograd.grad(torch.sum(y * torch.as_tensor(inputs["r"])),
                            (x,) + params)
    out = {"y": y.detach().numpy(),
           "grads": whole_grads(dict(zip(("x",) + names, g)),
                                {**slices, "x": None}, model)}
    n = cfg.lru_width // m
    chan = Slice(2, model.rank * n, n)
    xc = narrow(torch.as_tensor(inputs["xc"]), chan).clone()
    xc.requires_grad_(True)
    a, b = _gates(block, xc, model)
    loss = torch.sum(a * narrow(torch.as_tensor(inputs["ra"]), chan)
                     + b * narrow(torch.as_tensor(inputs["rb"]), chan))
    leaves = {"xc": xc, **{n: getattr(block, n) for n in GATE_LEAVES}}
    g = torch.autograd.grad(loss, list(leaves.values()))
    out["gates"] = {
        "a": unslice(a.detach(), chan, model).numpy(),
        "b": unslice(b.detach(), chan, model).numpy(),
        "grads": whole_grads(dict(zip(leaves, g)), {**slices, "xc": chan},
                             model)}
    return out


def elastic_hybrid(comm, batches, ckpt):
    """recurrentgemma SMOKE trained 2 steps at 2x2 with a checkpoint
    after the second, restored and saved again at 1x4 and from that at
    2x2 (``restore_sharded`` / ``save_sharded``); then runs resumed from
    the first checkpoint at 1x4 and, on rank 0, at 1x1 take the third
    step.  Returns the directories and the resumed runs' parameters (the
    1x4 run's in the one-rank layout)."""
    import os

    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import model_slices
    from repro_torch.launch.mesh import make_mesh, train_rules
    from repro_torch.launch.train import data_shards, train
    from repro_torch.models import init_model
    from repro_torch.train import AdamWConfig, restore_sharded, save_sharded
    cfg = get_smoke("recurrentgemma_2b")
    kw = dict(batch=4, seq=64, lr=1e-3, device="cpu", log=lambda *a: None)
    ocfg = AdamWConfig(lr=1e-3, warmup=1, total_steps=2)
    dirs = {k: os.path.join(ckpt, k) for k in ("2x2", "1x4", "2x2b")}
    meshes = {(2, 2): make_mesh(comm, 2, 2), (1, 4): make_mesh(comm, 1, 4)}
    first = meshes[(2, 2)]
    train(cfg, steps=2, ckpt=dirs["2x2"], ckpt_every=2,
          batches=iter(batches), data=first.data, model=first.model, **kw)
    for src, dst, (d, m) in (("2x2", "1x4", (1, 4)), ("1x4", "2x2b", (2, 2))):
        mesh = meshes[(d, m)]
        slices = model_slices(cfg, train_rules(cfg, m), m, mesh.model.rank)
        lm = init_model(cfg, seed=None, device="cpu", slices=slices)
        shards = data_shards(cfg, lm, mesh.data, m)
        step, opt = restore_sharded(
            dirs[src], lm, ocfg, shards,
            0 if mesh.data is None else mesh.data.rank, slices=slices)
        save_sharded(dirs[dst], step, lm, opt, ocfg, shards, mesh.data,
                     model=mesh.model, slices=slices)
        comm.barrier()
    four = meshes[(1, 4)]
    out = train(cfg, steps=3, ckpt=dirs["2x2"], ckpt_every=100,
                batches=iter(batches[2:]), model=four.model, **kw)
    slices = model_slices(cfg, train_rules(cfg, 4), 4, four.model.rank)
    resumed = {4: {"start": out["start"], "params": whole_grads(
        {n: p.detach() for n, p in out["model"].named_parameters()},
        slices, four.model)}}
    if comm.rank == 0:
        one = train(cfg, steps=3, ckpt=dirs["2x2"], ckpt_every=100,
                    batches=iter(batches[2:]), **kw)
        resumed[1] = {"start": one["start"], "params": _np_dict(
            dict(one["model"].named_parameters()))}
    comm.barrier()
    return {"dirs": dirs, "resumed": resumed}


def model_axis_world(comm, attention_cases, rglru_cases, elastic_args):
    """The head_dim-layout attention cases (``key: (arch, overrides, m,
    inputs, weights)``), the RG-LRU cases (``key: (m, inputs,
    weights)``) and the hybrid's elastic checkpoint."""
    return {"attention": {k: _attention_case(comm, *c)
                          for k, c in attention_cases.items()},
            "rglru": {k: _rglru_case(comm, *c)
                      for k, c in rglru_cases.items()},
            "elastic": elastic_hybrid(comm, *elastic_args)}


# ---------------------------------------------------------------------------
# test_torch_serve_model_axis.py
# ---------------------------------------------------------------------------

def _serve_case(comm, arch, overrides, heads, m, weights, batch, steps,
                max_seq):
    """Prefill and decode steps of one SMOKE config on a model group of
    ``m`` ranks (this rank's block of the world) under
    ``launch.mesh.serve_rules`` (``heads``: with the heads on "model"):
    the logits in the one-rank layout (a sliced head's vocab columns
    gathered over the group) and the collective bytes by kind."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import Mesh, serve_rules
    from repro_torch.serve import decode_step, prefill
    cfg = get_smoke(arch).replace(**overrides)
    model = sub_world(comm, m)
    rules = serve_rules(cfg, m)
    if heads:
        rules.update(heads="model")
    lm, slices = sliced_model(cfg, weights, Mesh(None, model), rules)
    head = slices["embed.head"]

    def whole(logits):
        if head is None:
            return logits.numpy().copy()
        return model.all_gather(logits.movedim(-1, 0)).movedim(
            0, -1).numpy().copy()
    before = dict(model.bytes_by_kind)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits, state = prefill(lm, tb, cfg, max_seq=max_seq, model=model,
                            slices=slices)
    out = [whole(logits)]
    for tok in steps:
        logits, state = decode_step(lm, state, torch.as_tensor(tok), cfg,
                                    model=model, slices=slices)
        out.append(whole(logits))
    return {"logits": out,
            "sliced": sorted(n for n, s in slices.items() if s is not None),
            "bytes": {k: v - before[k]
                      for k, v in model.bytes_by_kind.items()}}


def serve_model_axis_world(comm, cases):
    """``key: (arch, overrides, heads, m, weights, batch, steps,
    max_seq)`` -> ``_serve_case``'s result on this rank."""
    return {k: _serve_case(comm, *c) for k, c in cases.items()}


# ---------------------------------------------------------------------------
# test_torch_dryrun.py, test_torch_analysis.py
# ---------------------------------------------------------------------------

def dryrun_real_cell(comm, arch, shape, mesh_shape):
    """One cell of ``launch.dryrun`` run for real on this rank of a
    ``mesh_shape`` (d, m) mesh: the FLOPs the flop counter counts, the
    bytes of each collective kind (data and model groups together), and
    the parameter and moment bytes this rank holds.  Remat recomputes
    each layer whole (no early stop), as the caller's meta count does:
    the CPU's bf16 products take another route than the card's and the
    meta device's, and with early stop the two would recompute
    different tails of a layer."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProductionMesh, make_mesh
    d, m = mesh_shape
    mesh = make_mesh(comm, d, m)
    cell = dryrun.build_cell(
        arch, shape, multi_pod=False, unroll=False,
        cfg_override=get_smoke(arch), rank=comm.rank, device="cpu",
        mesh=ProductionMesh((d, m), ("data", "model")),
        comms=(mesh.data, mesh.model))
    args = {k: dryrun.nbytes(cell.args[k]) for k in ("params", "opt")
            if k in cell.args}
    flops = FlopCounterMode(display=False)
    with flops, set_checkpoint_early_stop(False):
        cell.step()
    coll = dryrun.collective_counts(cell)
    coll.pop("by_group")
    return {"flops": flops.get_total_flops(), "collectives": coll,
            "args": args}


def profiled_model_step(comm, arch, trace_dir):
    """One train step of ``arch``'s SMOKE config on a 1 x ``comm.size``
    mesh under the launcher's rules, under the torch profiler (shapes
    recorded): the step's ``model_bytes_by_kind``, the model group's
    counters over the step, and the path of this rank's Chrome trace."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_smoke
    from repro_torch.data import random_batch
    from repro_torch.distributed.sharding import model_slices
    from repro_torch.launch.mesh import train_rules
    from repro_torch.models import init_model
    from repro_torch.train import AdamWConfig, init_opt_state, \
        make_train_step
    cfg = get_smoke(arch)
    m = comm.size
    slices = model_slices(cfg, train_rules(cfg, m), m, comm.rank)
    lm = init_model(cfg, seed=0, device="cpu", slices=slices)
    ocfg = AdamWConfig()
    step = make_train_step(cfg, ocfg, model=comm, slices=slices)
    batch = {k: torch.as_tensor(v)
             for k, v in random_batch(cfg, b=2, s=32, seed=3).items()}
    before = dict(comm.bytes_by_kind)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        _, _, metrics = step(lm, init_opt_state(lm, ocfg), batch)
    path = os.path.join(trace_dir, f"rank{comm.rank}.json")
    p.export_chrome_trace(path)
    return {"by_kind": metrics["model_bytes_by_kind"],
            "counters": {k: v - before[k]
                         for k, v in comm.bytes_by_kind.items()},
            "trace": path, "batch": (2, 32)}


# ---------------------------------------------------------------------------
# test_torch_legacy.py
# ---------------------------------------------------------------------------

LEGACY_INFO_KEYS = ("imbalance", "cut", "TotalV", "MaxV", "retained",
                    "mig_weight_in", "mig_weight_out", "mig_items",
                    "mig_overflow", "capacity", "backend")


def legacy_info_of(res):
    """The deterministic part of a legacy result: its parts and the
    ``info`` entries that are not times."""
    info = res.info
    out = {k: info[k] for k in LEGACY_INFO_KEYS if k in info}
    out["keys"] = sorted(info)
    out["part_weights"] = np.asarray(info["part_weights"])
    if "remap_perm" in info:
        out["remap_perm"] = np.asarray(_np(info["remap_perm"]))
    return np.asarray(_np(res.parts)), out


def legacy_world(comm, coords, w, old, cases, serve_case):
    """The deprecated multi-device shims on this rank: each case
    ``(shim, method, oneD, use_old)`` runs ``DistributedBalancer`` or the
    sharded ``DynamicLoadBalancer``; then the refusals; then
    ``serve_case`` (cfg, weights, trace keywords) through ``ServeEngine``
    with its balancer sharded over the group."""
    import warnings
    from repro_torch.core import DynamicLoadBalancer
    from repro_torch.distributed import DistributedBalancer
    warnings.simplefilter("ignore", DeprecationWarning)
    out = {"cases": []}
    kw = dict(coords=torch.as_tensor(coords))
    for shim, method, oneD, use_old in cases:
        if shim == "distributed":
            b = DistributedBalancer(comm.size, method, comm=comm, oneD=oneD)
        else:
            b = DynamicLoadBalancer(comm.size, method, oneD=oneD,
                                    backend="sharded", comm=comm)
        r = b.balance(torch.as_tensor(w),
                      old_parts=torch.as_tensor(old) if use_old else None,
                      **kw)
        out["cases"].append(legacy_info_of(r))
    errors = []
    for make in (lambda: DistributedBalancer(comm.size, "rtk", comm=comm),
                 lambda: DistributedBalancer(comm.size, comm=comm).balance(
                     torch.as_tensor(w))):
        try:
            make()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    cfg, weights, trace_kw = serve_case
    from repro_torch.serve import ServeEngine, bursty_trace, run_trace
    eng = ServeEngine(model_from_numpy(cfg, weights), cfg, slots=8,
                      max_seq=64, n_groups=comm.size, rebalance_every=4,
                      backend="sharded", comm=comm)
    reqs, submit = [], eng.submit
    eng.submit = lambda r: (reqs.append(r), submit(r))[1]
    m = run_trace(eng, bursty_trace(24, vocab=cfg.vocab, **trace_kw))
    out["serve"] = ([r.out for r in reqs], m["migration_log"])
    return out


# ---------------------------------------------------------------------------
# test_torch_examples_world.py
# ---------------------------------------------------------------------------

def load_example(name):
    """The port's ``examples/torch/<name>.py`` as a module (the examples
    are scripts, not a package)."""
    import importlib.util
    import pathlib
    import sys
    mod_name = f"torch_example_{name}"
    if mod_name not in sys.modules:
        path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
                / "torch" / f"{name}.py")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def examples_world(comm):
    """The rank bodies of the two multi-rank examples, on this CPU rank."""
    return {"parallel_fem": load_example("parallel_fem").fem_rank(
                comm, "cpu", echo=False),
            "serve_continuous": load_example("serve_continuous").serve_rank(
                comm, "cpu", echo=False)}
