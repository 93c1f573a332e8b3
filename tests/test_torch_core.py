"""The port's core (SFC keys, 1-D partitioners, remap, metrics, RTK, RCB)
against the JAX package on shared numpy inputs, on the CPU.

Integer weights keep every float32 sum exact, so keys, parts, splitters
and rounds must be identical.  The ``Balancer`` has its own file."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.fem as JF
import repro_torch.core as T
from repro.core import partition1d as jp1d


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _mesh_coords():
    mesh = JF.cylinder_mesh(8, 2, length=4.0, radius=0.5)
    JF.uniform_refine(mesh, 4)
    return mesh.barycenters()                     # float64, like the session


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * np.array([10.0, 1.0, 1.0])).astype(np.float32)


# --- SFC ---------------------------------------------------------------------

@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("source", ["mesh", "random"])
def test_box_map_and_keys_bit_exact(uniform, source):
    coords = _mesh_coords() if source == "mesh" else _points(20_000, 1)
    jc = jnp.asarray(coords)                      # float32, as the reference
    tc = torch.as_tensor(coords.astype(np.float32))
    jlo, jhi = J.bounding_box(jc)
    tlo, thi = T.bounding_box(tc)
    np.testing.assert_array_equal(_np(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(
        _np(T.box_map(tc, tlo, thi, uniform=uniform)),
        np.asarray(J.box_map(jc, jlo, jhi, uniform=uniform)).astype(np.int64))
    for curve in ("hilbert", "morton"):
        want = J.sfc_keys(jc, jlo, jhi, curve=curve, uniform=uniform)
        got = T.sfc_keys(tc, tlo, thi, curve=curve, uniform=uniform)
        np.testing.assert_array_equal(_np(got), np.asarray(want).astype(np.int64))


def test_refresh_key_cache_matches_reference():
    coords = _mesh_coords()
    jc, info = J.refresh_key_cache(None, coords)
    tc, tinfo = T.refresh_key_cache(None, coords, device="cpu")
    assert info["mode"] == tinfo["mode"] == "full"
    np.testing.assert_array_equal(tc.keys, jc.keys.astype(np.int64))
    moved = coords.copy()
    rng = np.random.default_rng(0)
    dirty = rng.random(len(coords)) < 0.05
    moved[dirty] += 0.001
    jc2, info = J.refresh_key_cache(jc, moved, dirty)
    tc2, tinfo = T.refresh_key_cache(tc, moved, dirty, device="cpu")
    assert info == tinfo
    np.testing.assert_array_equal(tc2.keys, jc2.keys.astype(np.int64))


# --- 1-D partitioners --------------------------------------------------------

def _keys_weights(n, seed):
    rng = np.random.default_rng(seed)
    coords = _points(n, seed)
    jc = jnp.asarray(coords)
    lo, hi = J.bounding_box(jc)
    keys = np.asarray(J.sfc_keys(jc, lo, hi)).astype(np.int64)
    w = rng.integers(1, 5, n).astype(np.float32)
    return keys, w


def _same_p1d(a, b):
    np.testing.assert_array_equal(_np(a.parts), np.asarray(b.parts))
    np.testing.assert_array_equal(_np(a.splitters), np.asarray(b.splitters))
    np.testing.assert_array_equal(_np(a.part_weights),
                                  np.asarray(b.part_weights))


@pytest.mark.parametrize("p", [1, 16, 128])
def test_sorted_exact_matches(p):
    keys, w = _keys_weights(10_000, p)
    _same_p1d(T.sorted_exact(torch.as_tensor(keys), torch.as_tensor(w), p),
              J.sorted_exact(jnp.asarray(keys.astype(np.uint32)),
                             jnp.asarray(w), p))


def test_weight_below_matches():
    keys, w = _keys_weights(5_000, 3)
    rng = np.random.default_rng(3)
    cuts = rng.choice(keys, 300).astype(np.float32)
    cuts[:50] = rng.random(50).astype(np.float32) * keys.max()
    kf = keys.astype(np.float32)
    np.testing.assert_array_equal(
        _np(T.weight_below(torch.as_tensor(kf), torch.as_tensor(w),
                           torch.as_tensor(cuts))),
        np.asarray(jp1d.weight_below(jnp.asarray(kf), jnp.asarray(w),
                                     jnp.asarray(cuts))))


@pytest.mark.parametrize("p", [16, 128])
@pytest.mark.parametrize("warm", [False, True])
def test_ksection_matches_cold_and_warm(p, warm):
    keys, w = _keys_weights(10_000, p + 1)
    jk, jw = jnp.asarray(keys.astype(np.uint32)), jnp.asarray(w)
    tk, tw = torch.as_tensor(keys), torch.as_tensor(w)
    jprev = tprev = None
    if warm:
        # splitters of a perturbed weighting: stale but close boxes
        w2 = w.copy()
        w2[: len(w) // 3] += 1.0
        jprev = J.ksection(jk, jnp.asarray(w2), p).splitters
        tprev = T.ksection(tk, torch.as_tensor(w2), p).splitters
        np.testing.assert_array_equal(_np(tprev), np.asarray(jprev))
    for tol in (0.0, 0.5):
        want = J.ksection(jk, jw, p, warm=jprev, tol=tol)
        got = T.ksection(tk, tw, p, warm=tprev, tol=tol)
        _same_p1d(got, want)
        assert got.rounds == int(want.rounds)


def test_warm_start_boxes_degenerate_splitters():
    keys, w = _keys_weights(2_000, 9)
    kf = keys.astype(np.float32)
    p = 16
    prev = np.full(p - 1, float(np.median(kf)), np.float32)   # zero-width
    targets = np.float32(w.sum()) * np.arange(1, p, dtype=np.float32) / p
    lo, hi = np.float32(kf.min()), np.float32(kf.max() + 1)
    jh = lambda c: jp1d.weight_below(jnp.asarray(kf), jnp.asarray(w), c)  # noqa
    th = lambda c: T.weight_below(torch.as_tensor(kf), torch.as_tensor(w), c)  # noqa
    jb = J.warm_start_boxes(jnp.asarray(prev), lo, hi, jnp.asarray(targets), jh)
    tb = T.warm_start_boxes(prev, lo, hi, torch.as_tensor(targets), th)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# --- remap, metrics, RTK, RCB ------------------------------------------------

def test_similarity_and_guarded_greedy_match():
    rng = np.random.default_rng(5)
    n, p = 5_000, 16
    old = rng.integers(0, p + 1, n)            # includes the pad part p
    new = rng.integers(0, p, n)
    w = rng.integers(1, 4, n).astype(np.float32)
    jS = J.similarity_matrix(jnp.asarray(old), jnp.asarray(new),
                             jnp.asarray(w), p, p)
    tS = T.similarity_matrix(torch.as_tensor(old), torch.as_tensor(new),
                             torch.as_tensor(w), p, p)
    np.testing.assert_array_equal(_np(tS), np.asarray(jS))
    from repro.core.remap import guarded_greedy_perm
    np.testing.assert_array_equal(_np(T.guarded_greedy_perm(tS)),
                                  np.asarray(guarded_greedy_perm(jS)))


def test_metrics_match():
    rng = np.random.default_rng(6)
    n, p = 3_000, 8
    old, new = rng.integers(0, p, n), rng.integers(0, p, n)
    w = rng.integers(1, 4, n).astype(np.float32)
    adj = rng.integers(0, n, (4_000, 2))
    jq = J.quality(jnp.asarray(new), jnp.asarray(w), p, jnp.asarray(adj))
    tq = T.quality(torch.as_tensor(new), torch.as_tensor(w), p,
                   torch.as_tensor(adj))
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    jm = J.migration_volume(jnp.asarray(old), jnp.asarray(new), jnp.asarray(w), p)
    tm = T.migration_volume(torch.as_tensor(old), torch.as_tensor(new),
                            torch.as_tensor(w), p)
    for k in jm:
        assert float(tm[k]) == float(jm[k])


@pytest.mark.parametrize("p", [16, 128])
def test_partition_dfs_and_rcb_match(p):
    rng = np.random.default_rng(p)
    w = rng.integers(1, 6, 10_000).astype(np.float32)
    np.testing.assert_array_equal(
        _np(T.partition_dfs(torch.as_tensor(w), p)),
        np.asarray(J.partition_dfs(jnp.asarray(w), p)))
    coords = _points(10_000, p)
    np.testing.assert_array_equal(
        _np(T.rcb_partition(torch.as_tensor(coords), torch.as_tensor(w), p)),
        np.asarray(J.rcb_partition(jnp.asarray(coords), jnp.asarray(w), p)))


def test_rtk_forest_matches():
    from repro.core.rtree import RefinementForest as JForest
    f, g = T.RefinementForest.from_roots(6), JForest.from_roots(6)
    for nodes in ([0, 3], [7, 1], [9, 10, 2]):
        f.split(np.asarray(nodes))
        g.split(np.asarray(nodes))
    np.testing.assert_array_equal(f.leaves_dfs(), g.leaves_dfs())
    wn = np.arange(f.n_nodes, dtype=np.float32) + 1
    np.testing.assert_array_equal(T.rtk_partition_forest(f, wn, 4),
                                  J.rtk_partition_forest(g, wn, 4))
