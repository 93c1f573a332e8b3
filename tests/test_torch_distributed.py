"""The port's multi-device layer (collectives, the MPI_Scan helpers, the
migration executor and the sharded ``Balancer``) against the JAX package,
on the CPU.

The port runs one process per rank: a gloo world of 4 CPU ranks
(``repro_torch.distributed.run_world``; the rank bodies are in
``_torch_world.py``).  The JAX package runs the same functions in one
``shard_map`` over 4 of the suite's 8 host devices.  Each rank's shard of
a result, concatenated in rank order, is the JAX package's global array.
Integer weights keep every float32 sum exact, so parts, splitters,
weights, permutations and migration scalars must be identical.  One
world serves the whole file (module fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import repro.core as J
import repro_torch.core as T
from repro.core import partition1d as jp1d
from repro.distributed.migrate import migrate_items as j_migrate_items
from repro.distributed.sharding import shard_map
from repro_torch.distributed import dispatch_slots, payload_nbytes

import _torch_world as W

P4 = 4
SHARDED_METHODS = ("hsfc", "msfc", "hsfc_zoltan", "linear")
N_ITEMS = 3000


def _jmesh():
    return Mesh(np.array(jax.devices()[:P4]), ("x",))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * np.array([10.0, 1.0, 1.0])).astype(np.float32)


def _balance_inputs():
    rng = np.random.default_rng(1)
    coords = _points(N_ITEMS, 2)
    w = rng.integers(1, 4, N_ITEMS).astype(np.float32)
    old = rng.integers(0, P4, N_ITEMS).astype(np.int64)
    return coords, w, old


def _balance_cases():
    """(spec dict, use_old, warm): every sharded method x oneD, cold and
    with old parts; warm-started k-section; the plan without migration."""
    cases = []
    for m in SHARDED_METHODS:
        for o in ("sorted", "ksection"):
            for use_old in (False, True):
                spec = J.BalanceSpec(p=P4, method=m, oneD=o, backend="sharded")
                cases.append((spec.to_dict(), use_old, False))
    for m in ("hsfc", "msfc"):
        spec = J.BalanceSpec(p=P4, method=m, oneD="ksection",
                             backend="sharded", ksection_tol=0.5)
        cases.append((spec.to_dict(), True, True))
    spec = J.BalanceSpec(p=P4, method="hsfc", backend="sharded",
                         execute_migration=False)
    cases.append((spec.to_dict(), True, False))
    return cases


CASES = _balance_cases()


def _collective_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(P4 * 8, 2)).astype(np.float32)
    Cm = 50
    dest = rng.integers(0, P4, P4 * Cm).astype(np.int64)
    pay = rng.normal(size=(P4 * Cm, 3)).astype(np.float32)
    w = rng.integers(1, 4, P4 * Cm).astype(np.float32)
    valid = rng.random(P4 * Cm) < 0.9
    scan_w = rng.integers(0, 5, P4 * 40).astype(np.float32)
    return x, w, dest, pay, valid, scan_w


CAPACITIES = (None, 60)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One gloo world of 4 CPU ranks for the whole file."""
    tmp = tmp_path_factory.mktemp("world")
    coords, w, old = _balance_inputs()
    x, mw, dest, pay, valid, scan_w = _collective_inputs()

    return W.world(W.collectives_and_balances,
                   (x, mw, dest, pay, valid, CAPACITIES, scan_w),
                   (coords, w, old, CASES), tmp_path=tmp)


# --- Comm ---------------------------------------------------------------------

def test_comm_collectives_are_tiled_like_jax(ranks):
    x = _collective_inputs()[0]
    C = x.shape[0] // P4
    blocks = x.reshape(P4, C, -1)
    for r, out in enumerate(ranks):
        c = out["collectives"]
        np.testing.assert_array_equal(c["all_gather"], x)
        np.testing.assert_allclose(c["psum"], blocks.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(c["pmin"], blocks.min(0))
        np.testing.assert_array_equal(c["pmax"], blocks.max(0))
        np.testing.assert_array_equal(c["broadcast"], blocks[0])
        # block d of rank s arrives as block s of rank d
        sub = C // P4
        want = np.concatenate([blocks[s][r * sub:(r + 1) * sub]
                               for s in range(P4)])
        np.testing.assert_array_equal(c["all_to_all"], want)
        np.testing.assert_array_equal(c["all_to_all_async"], 2 * want)
        assert c["staged_bytes"] == 0            # CPU tensors: no copies


def test_jax_all_to_all_tiling_matches():
    """The JAX package's tiled all_to_all moves the same blocks as
    ``Comm.all_to_all`` (the tiling both executors rely on)."""
    x = _collective_inputs()[0]
    f = shard_map(lambda a: jax.lax.all_to_all(a, "x", 0, 0, tiled=True),
                  mesh=_jmesh(), in_specs=P("x"), out_specs=P("x"))
    got = np.asarray(f(jnp.asarray(x)))
    C, sub = x.shape[0] // P4, x.shape[0] // P4 // P4
    blocks = x.reshape(P4, C, -1)
    want = np.concatenate([np.concatenate([blocks[s][d * sub:(d + 1) * sub]
                                           for s in range(P4)])
                           for d in range(P4)])
    np.testing.assert_array_equal(got, want)


def test_world_size_must_equal_parts():
    class FakeComm:
        rank, size, device = 0, 2, torch.device("cpu")
    with pytest.raises(ValueError, match="world size 2"):
        T.Balancer(T.BalanceSpec(p=4, backend="sharded"), comm=FakeComm())
    with pytest.raises(ValueError, match="process group"):
        T.Balancer(T.BalanceSpec(p=4, backend="sharded"), device="cpu")


def test_run_world_refuses_nccl_without_cards(tmp_path):
    from repro_torch.distributed import run_world
    if torch.cuda.device_count() >= P4:
        pytest.skip("enough cards for NCCL here")
    with pytest.raises(ValueError, match="one card per rank"):
        run_world(W.collectives_and_balances, P4, backend="nccl",
                  init_file=str(tmp_path / "rdv"))


def test_run_world_reports_a_failing_rank(tmp_path):
    from repro_torch.distributed import run_world
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_world(W.fail_on_rank_1, 2, init_file=str(tmp_path / "rdv"),
                  devices=["cpu"] * 2, timeout_s=20.0, join_s=60.0)


# --- the MPI_Scan step --------------------------------------------------------

def test_scan_over_axis_and_prefix_parts_match_jax(ranks):
    scan_w = _collective_inputs()[-1]
    C = scan_w.shape[0] // P4
    f = shard_map(lambda w: jp1d.exclusive_scan_over_axis(jnp.sum(w), "x")[None],
                  mesh=_jmesh(), in_specs=P("x"), out_specs=P("x"))
    want_off = np.asarray(f(jnp.asarray(scan_w)))
    g = shard_map(lambda w: jp1d.distributed_prefix_parts(w, P4, "x"),
                  mesh=_jmesh(), in_specs=P("x"), out_specs=P("x"))
    want_parts = np.asarray(g(jnp.asarray(scan_w)))
    got_parts = np.concatenate([o["collectives"]["prefix_parts"]
                                for o in ranks])
    for r, o in enumerate(ranks):
        assert o["collectives"]["scan_over_axis"] == want_off[r]
        assert want_off[r] == scan_w[:r * C].sum()
    np.testing.assert_array_equal(got_parts, want_parts.astype(np.int64))
    # and the host Algorithm 1 on the whole array
    np.testing.assert_array_equal(
        got_parts, T.prefix_sum_parts(torch.as_tensor(scan_w), P4).numpy())


# --- migration executor -------------------------------------------------------

def test_dispatch_slots_matches_jax():
    from repro.distributed.migrate import dispatch_slots as j_dispatch
    rng = np.random.default_rng(4)
    dest = rng.integers(0, 5, 200)
    valid = rng.random(200) < 0.8
    js, jd = j_dispatch(jnp.asarray(dest, jnp.int32), jnp.asarray(valid), 5)
    ts, td = dispatch_slots(torch.as_tensor(dest), torch.as_tensor(valid), 5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_payload_nbytes_matches_jax():
    from repro.distributed.migrate import payload_nbytes as j_nbytes
    pay = {"a": np.zeros((7, 4, 3), np.float32), "b": np.zeros((7,), np.int64)}
    assert payload_nbytes({k: torch.as_tensor(v) for k, v in pay.items()}) \
        == j_nbytes(pay) == 4 * 12 + 8


@pytest.mark.parametrize("ci", range(len(CAPACITIES)))
def test_migrate_items_matches_jax(ranks, ci):
    _, w, dest, pay, valid, _ = _collective_inputs()
    cap = CAPACITIES[ci]
    ids = np.arange(dest.shape[0])

    def body(pay, ids, dest, w, valid):
        m = j_migrate_items({"x": pay, "id": ids}, dest, w, "x", P4,
                            valid=valid, capacity=cap)
        sc = jnp.stack([m.n_recv.astype(jnp.float32),
                        m.overflow.astype(jnp.float32), m.w_sent,
                        m.w_received, m.w_kept])[None]
        return m.payload["x"], m.payload["id"], m.weights, m.valid, sc
    f = jax.jit(shard_map(body, mesh=_jmesh(), in_specs=(P("x"),) * 5,
                          out_specs=(P("x"),) * 5))
    jx, jid, jw, jv, jsc = map(np.asarray, f(
        jnp.asarray(pay), jnp.asarray(ids, jnp.int32),
        jnp.asarray(dest, jnp.int32), jnp.asarray(w), jnp.asarray(valid)))
    R = jx.shape[0] // P4
    for r, o in enumerate(ranks):
        m = o["collectives"]["migrate"][ci]
        sl = slice(r * R, (r + 1) * R)
        np.testing.assert_array_equal(m["x"], jx[sl])
        np.testing.assert_array_equal(m["id"], jid[sl])
        np.testing.assert_array_equal(m["weights"], jw[sl])
        np.testing.assert_array_equal(m["valid"], jv[sl])
        assert [m[k] for k in ("n_recv", "overflow", "w_sent", "w_received",
                               "w_kept")] == jsc[r].tolist()
    # every valid item delivered exactly once (the default window)
    if cap is None:
        got = np.concatenate([o["collectives"]["migrate"][ci]["id"][
            o["collectives"]["migrate"][ci]["valid"]] for o in ranks])
        np.testing.assert_array_equal(np.sort(got), ids[valid])
        for r, o in enumerate(ranks):
            m = o["collectives"]["migrate"][ci]
            assert np.all(dest[m["id"][m["valid"]]] == r)


# --- the sharded Balancer -----------------------------------------------------

def _jax_balance(spec_d, use_old, warm):
    coords, w, old = _balance_inputs()
    b = J.Balancer(J.BalanceSpec.from_dict(spec_d))
    kw = dict(coords=jnp.asarray(coords),
              old_parts=jnp.asarray(old, jnp.int32) if use_old else None)
    r = b.balance(jnp.asarray(w), **kw)
    if warm:
        r = b.balance(jnp.asarray(w), warm_splitters=r.splitters, **kw)
    return r


@pytest.mark.parametrize("ci", range(len(CASES)),
                         ids=[f"{c[0]['method']}-{c[0]['oneD']}-"
                              f"{'old' if c[1] else 'cold'}"
                              f"{'-warm' if c[2] else ''}"
                              f"{'' if c[0]['execute_migration'] else '-plan'}"
                              for c in CASES])
def test_sharded_balancer_matches_jax_and_host(ranks, ci):
    spec_d, use_old, warm = CASES[ci]
    want = _jax_balance(spec_d, use_old, warm)
    results = [o["balances"][ci] for o in ranks]
    for got in results:
        for f in W.BALANCE_FIELDS:
            a, b = got[f], getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(
                    a, np.asarray(b).astype(a.dtype), err_msg=f)
        if spec_d["oneD"] == "ksection":
            assert got["ksection_rounds"] == int(want.ksection_rounds)
        if use_old and spec_d["execute_migration"]:
            assert got["migration"] is not None
            for k, v in want.migration.items():
                assert float(got["migration"][k]) == float(v), k
            assert got["migration"]["weight_in"] == \
                got["migration"]["weight_out"]
            assert got["migration"]["overflow"] == 0
        else:
            assert got["migration"] is None and want.migration is None
    # each rank's shard of the pipeline, concatenated, is the global parts
    n = N_ITEMS
    cat = np.concatenate([g["rank_parts"] for g in results])[:n]
    if not warm:
        np.testing.assert_array_equal(cat, results[0]["parts"])
    # and the port's own host backend gives the same partition
    coords, w, old = _balance_inputs()
    host_spec = T.BalanceSpec.from_dict(dict(spec_d, backend="host"))
    hb = T.Balancer(host_spec, device="cpu")
    kw = dict(coords=coords, old_parts=old if use_old else None)
    hr = hb.balance(w, **kw)
    if warm:
        hr = hb.balance(w, warm_splitters=hr.splitters, **kw)
    np.testing.assert_array_equal(hr.parts.numpy(), results[0]["parts"])
    np.testing.assert_array_equal(hr.part_weights.numpy(),
                                  results[0]["part_weights"])


@pytest.mark.parametrize("method", ["rtk", "rcb"])
def test_sharded_direct_methods_refused_like_jax(method):
    """RTK and RCB have no sharded variant in either package."""
    with pytest.raises(ValueError):
        J.Balancer(J.BalanceSpec(p=P4, method=method, backend="sharded"))

    class FakeComm:
        rank, size, device = 0, P4, torch.device("cpu")
    with pytest.raises(ValueError, match="no 'partition1d' stage variant"):
        T.Balancer(T.BalanceSpec(p=P4, method=method, backend="sharded"),
                   comm=FakeComm())
