"""The port's kernel dispatch and plain versions against the JAX package's
oracles and its Pallas kernels (interpret mode), on the CPU.

The hand-written CUDA kernels themselves run only on a card; they are
held against these plain versions in test_torch_cuda.py (which imports
no JAX, so it runs on the machine with the card) and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fem_matvec import fem_element_matrices as j_element_matrices
from repro.kernels.fem_matvec import fem_matvec_jnp, fem_matvec_pallas
from repro.kernels import ksection_hist as jks
from repro.kernels.ksection_hist import ksection_histogram_pallas
from repro_torch.core import sfc as tsfc
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fem_matvec import (CHUNK, build_element_plan,
                                            fem_element_matrices,
                                            fem_matvec_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ksection_hist import ksection_hist_cuda
from repro_torch.kernels.prefix_scan import exclusive_scan_cuda
from repro_torch.kernels.serve_prefill import packed_attention_cuda
from repro_torch.kernels.sfc_keys import sfc_keys_cuda
from repro_torch.segment import segment_sum_any_order


# --- sfc_keys --------------------------------------------------------------

def _grid(n, bits, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1 << bits, (n, 3))
    top = (1 << bits) - 1
    g[:4] = [[0, 0, 0], [top, top, top], [0, top, 0], [top, 0, top]]
    return g


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("bits", list(range(1, 11)))
def test_sfc_keys_plain_bit_exact(curve, bits):
    g = _grid(1000 + bits, bits, bits)      # n not a multiple of any block
    fn = jref.hilbert_keys_ref if curve == "hilbert" else jref.morton_keys_ref
    want = np.asarray(fn(jnp.asarray(g.astype(np.uint32)), bits))
    got = ops.sfc_keys_op(torch.as_tensor(g), curve=curve, bits=bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
def test_sfc_keys_plain_matches_pallas_kernel(curve):
    g = _grid(1000, 10, 7)
    want = np.asarray(jops.sfc_keys_op(jnp.asarray(g.astype(np.uint32)),
                                       curve=curve, use_pallas=True,
                                       interpret=True))
    got = ops.sfc_keys_op(torch.as_tensor(g), curve=curve).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("bits", [3, 10])
def test_sfc_decoders_invert_and_match(bits):
    g = _grid(500, bits, 3)
    gt = torch.as_tensor(g)
    for enc, dec in ((tsfc.morton_encode, tsfc.morton_decode),
                     (tsfc.hilbert_encode, tsfc.hilbert_decode)):
        np.testing.assert_array_equal(dec(enc(gt, bits), bits).numpy(), g)


def _all_points(bits):
    """Every point of the 2^bits grid, (2^(3 bits), 3)."""
    g = np.arange(1 << (3 * bits))
    side = 1 << bits
    return np.stack([g // (side * side), (g // side) % side, g % side], 1)


@pytest.mark.parametrize("twin", ["table", "identities"])
@pytest.mark.parametrize("bits", list(range(1, 8)))
def test_hilbert_kernel_twins_match_jax_everywhere(twin, bits):
    """The kernel's formulations of Hilbert, in plain torch, on every
    point of the grid: the table walk, and Skilling's loop with the
    prefix-XOR Gray step and the spread interleave."""
    from repro.kernels.sfc_keys import _hilbert_body
    g = _all_points(bits)
    want = np.asarray(_hilbert_body(*(jnp.asarray(g[:, a], jnp.int32)
                                      for a in range(3)), bits))
    fn = (ref.hilbert_keys_table_ref if twin == "table"
          else ref.hilbert_keys_identities_ref)
    got = fn(torch.as_tensor(g), bits)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("twin", ["table", "identities"])
def test_hilbert_kernel_twins_at_ten_bits(twin):
    g = _grid(50_000, 10, 10)
    fn = (ref.hilbert_keys_table_ref if twin == "table"
          else ref.hilbert_keys_identities_ref)
    want = np.asarray(jref.hilbert_keys_ref(jnp.asarray(g.astype(np.uint32)),
                                            10))
    np.testing.assert_array_equal(fn(torch.as_tensor(g), 10).numpy(),
                                  want.astype(np.int64))


def test_hilbert_table_shape():
    """48 states (24 orientations x 2 parities) and the odd-start row;
    every entry's next row is a state row."""
    from repro_torch.kernels.sfc_keys import (HILBERT_STATES, ODD_START,
                                              hilbert_states, hilbert_table)
    states, _ = hilbert_states()
    table = hilbert_table()
    assert len(states) == HILBERT_STATES == 48 and ODD_START == 48
    assert table.shape == (49 * 64,) and table.dtype == np.int16
    assert int((table >> 6).max()) < HILBERT_STATES


# --- ksection_hist -----------------------------------------------------------
# Integer weights make every partial sum exact: the plain version, the JAX
# oracle and the Pallas kernel agree bit for bit.

def _hist_case(n, m, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 50, n).astype(np.float32)      # many duplicates
    w = rng.integers(0, 10, n).astype(np.float32)
    cuts = rng.integers(0, 52, m).astype(np.float32)      # unsorted, dups
    if m > 2 and n > 0:
        cuts[:2] = keys[:2]                                # cut == key
    return keys, w, cuts


@pytest.mark.parametrize("n,m", [(1000, 37), (4096, 504), (3, 1), (1, 9),
                                 (0, 5), (7, 0), (0, 0)])
def test_ksection_hist_plain_exact(n, m):
    keys, w, cuts = _hist_case(n, m, n + m)
    got = ops.ksection_histogram_op(torch.as_tensor(keys), torch.as_tensor(w),
                                    torch.as_tensor(cuts))
    assert got.dtype == torch.float32 and got.shape == (m,)
    want = np.asarray(jref.ksection_histogram_ref(
        jnp.asarray(keys), jnp.asarray(w), jnp.asarray(cuts)))
    np.testing.assert_array_equal(got.numpy(), want)
    if n >= 1000 and m:
        pallas = np.asarray(ksection_histogram_pallas(
            jnp.asarray(keys), jnp.asarray(w), jnp.asarray(cuts),
            interpret=True))
        np.testing.assert_array_equal(got.numpy(), pallas)


def test_ksection_hist_sentinel_tail():
    """+inf keys with zero weight (the padded tail) count for no cut."""
    keys, w, cuts = _hist_case(600, 40, 1)
    keys[-100:] = np.inf
    w[-100:] = 0.0
    got = ops.ksection_histogram_op(torch.as_tensor(keys), torch.as_tensor(w),
                                    torch.as_tensor(cuts)).numpy()
    want = np.asarray(ksection_histogram_pallas(
        jnp.asarray(keys), jnp.asarray(w), jnp.asarray(cuts), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ops.ksection_histogram_op(torch.as_tensor(keys[:-100]),
                                       torch.as_tensor(w[:-100]),
                                       torch.as_tensor(cuts)).numpy())


# The kernel's own formulation (cut ranks, buckets by searchsorted(right),
# prefix, scatter by rank) in plain torch: equal to the JAX package's
# kernel on integer weights, within 1e-6 of sum|w| on float weights.

TWIN_CASES = {"dups": (4096, 504), "chunked": (3000, 9000), "one": (1, 9),
              "one_cut": (500, 1), "no_items": (0, 5), "no_cuts": (7, 0),
              "none": (0, 0)}


@pytest.mark.parametrize("name", sorted(TWIN_CASES))
def test_ksection_rank_twin_exact_on_integers(name):
    n, m = TWIN_CASES[name]
    keys, w, cuts = _hist_case(n, m, n * 7 + m)
    if n > 20:
        keys[-20:] = np.inf                                 # padded tail
        w[-20:] = 0.0
    if m > 8:
        cuts[3:8] = cuts[2]                                 # a collapsed box
    args = [jnp.asarray(a) for a in (keys, w, cuts)]
    got = ref.ksection_rank_ref(*(torch.as_tensor(a)
                                  for a in (keys, w, cuts))).numpy()
    assert got.dtype == np.float32 and got.shape == (m,)
    np.testing.assert_array_equal(
        got, np.asarray(ksection_histogram_pallas(*args, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(
        jks.ksection_histogram_jnp(*args)))


@pytest.mark.parametrize("n,m", [(5000, 504), (2000, 8184)])
def test_ksection_rank_twin_close_on_floats(n, m):
    rng = np.random.default_rng(m)
    keys = rng.standard_normal(n).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    cuts = rng.standard_normal(m).astype(np.float32)
    cuts[::9] = keys[:len(cuts[::9])]
    got = ref.ksection_rank_ref(*(torch.as_tensor(a)
                                  for a in (keys, w, cuts))).numpy()
    want = np.asarray(ksection_histogram_pallas(
        *(jnp.asarray(a) for a in (keys, w, cuts)), interpret=True))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(w).sum()


# --- fem_matvec --------------------------------------------------------------

def _matvec_case(C, V, n_out, seed):
    rng = np.random.default_rng(seed)
    tets = rng.integers(0, n_out + 1, (C, 4)).astype(np.int32)  # incl. pad slot
    grads = rng.standard_normal((C, 4, 3)).astype(np.float32)
    vol = rng.random(C).astype(np.float32)
    vol[::7] = 0.0                                              # no-op rows
    # the pad slot belongs to padding elements only, which carry K_e = 0
    # (the JAX implementations read a different value there)
    vol[(tets == n_out).any(axis=1)] = 0.0
    u = rng.standard_normal(V).astype(np.float32)
    return tets, grads, vol, u


@pytest.mark.parametrize("C,V,n_out,c", [(300, 80, 80, 0.0),
                                         (300, 96, 80, 1.5),
                                         (257, 40, 33, 0.0),
                                         (0, 10, 10, 0.0)])
def test_fem_matvec_plain_matches_reference(C, V, n_out, c):
    tets, grads, vol, u = _matvec_case(C, V, n_out, C + V)
    jkel = j_element_matrices(jnp.asarray(grads), jnp.asarray(vol), c)
    kel = fem_element_matrices(torch.as_tensor(grads), torch.as_tensor(vol), c)
    np.testing.assert_allclose(kel.numpy(), np.asarray(jkel), rtol=1e-5,
                               atol=1e-6)
    want = np.asarray(jref.fem_matvec_ref(jnp.asarray(tets), jnp.asarray(grads),
                                          jnp.asarray(vol), jnp.asarray(u),
                                          n_out, c=c))
    tol = dict(rtol=1e-5, atol=1e-5 * max(np.abs(want).max(initial=0.0), 1.0))
    got = ops.fem_matvec_op(torch.as_tensor(tets), kel, torch.as_tensor(u),
                            n_out)
    assert got.shape == (n_out,)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    geom = ref.fem_matvec_ref(torch.as_tensor(tets), torch.as_tensor(grads),
                              torch.as_tensor(vol), torch.as_tensor(u), n_out,
                              c=c)
    np.testing.assert_allclose(geom.numpy(), want, **tol)
    if C:
        pallas = np.asarray(fem_matvec_pallas(jnp.asarray(tets), jkel,
                                              jnp.asarray(u), n_out,
                                              interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, **tol)


# The kernel's plan (build_element_plan) and its two passes in plain torch
# (ref.fem_matvec_plan_ref) against the JAX package's fem_matvec_jnp and
# its Pallas kernel in interpret mode.  Tolerance 1e-5 of max|y|: the
# same float32 products summed in other orders.

def _plan_case(case):
    """(tets, kel (numpy, JAX's element matrices), u, n_out, ranges)."""
    C, V, n_out, pad_chunk = case
    tets, grads, vol, u = _matvec_case(C, V, n_out, C + V + n_out)
    if pad_chunk:                # elements [CHUNK, 2 CHUNK) all padding
        tets[CHUNK:2 * CHUNK] = n_out
        vol[CHUNK:2 * CHUNK] = 0.0
    kel = np.array(j_element_matrices(jnp.asarray(grads), jnp.asarray(vol),
                                      1.0))
    return tets, kel, u, n_out


PLAN_CASES = {
    "ragged": (700, 150, 150, False),          # C not a multiple of CHUNK
    "pad_chunk": (3 * 256 + 5, 90, 90, True),  # an all-padding chunk
    "pad_slot": (600, 200, 180, False),        # V > n_out, slot n_out read
    "empty": (0, 10, 10, False),
}


def _plan_y(tets, kel, u, n_out):
    plan = build_element_plan(torch.as_tensor(tets), n_out)
    return plan, ref.fem_matvec_plan_ref(plan, torch.as_tensor(kel),
                                         torch.as_tensor(u))


def _hold_against_jax(got, tets, kel, u, n_out):
    want = np.asarray(fem_matvec_jnp(jnp.asarray(tets), jnp.asarray(kel),
                                     jnp.asarray(u), n_out))
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    assert got.shape == (n_out,)
    assert float(np.abs(got - want).max(initial=0.0)) <= 1e-5 * scale
    if tets.shape[0]:
        pallas = np.asarray(fem_matvec_pallas(jnp.asarray(tets),
                                              jnp.asarray(kel),
                                              jnp.asarray(u), n_out,
                                              interpret=True))
        assert float(np.abs(got - pallas).max()) <= 1e-5 * scale


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_element_plan_matches_reference(name):
    tets, kel, u, n_out = _plan_case(PLAN_CASES[name])
    plan, got = _plan_y(tets, kel, u, n_out)
    _hold_against_jax(got.numpy(), tets, kel, u, n_out)
    op = ops.ElementOperator(torch.as_tensor(tets), torch.as_tensor(kel),
                             n_out)
    _hold_against_jax(op.apply(torch.as_tensor(u)).numpy(), tets, kel, u,
                      n_out)
    if name == "pad_chunk":      # the padding chunk has one local vertex
        off = plan.chunk_off.numpy()
        assert off[2] - off[1] == 1 and plan.gid[off[1]] == n_out


@pytest.mark.parametrize("lo,hi", [(0, None), (0, 300), (300, None)])
def test_element_plan_sharded_ranges(lo, hi):
    """The three element ranges of the overlapped owned matvec (all, the
    interface rows, the interior rows), each with a plan of its own."""
    tets, kel, u, n_out = _plan_case((700, 150, 140, False))
    _, got = _plan_y(tets[lo:hi], kel[lo:hi], u, n_out)
    _hold_against_jax(got.numpy(), tets[lo:hi], kel[lo:hi], u, n_out)


def test_element_plan_in_another_order():
    """A plan of the elements in another order gives the same y."""
    tets, kel, u, n_out = _plan_case(PLAN_CASES["ragged"])
    perm = np.random.default_rng(3).permutation(tets.shape[0])
    _, got = _plan_y(tets[perm], kel[perm], u, n_out)
    _hold_against_jax(got.numpy(), tets, kel, u, n_out)


@pytest.mark.parametrize("name", ["ragged", "pad_chunk", "pad_slot"])
def test_element_plan_invariants(name):
    """Every (element, corner) below n_out lands in exactly one partial,
    the partial of its vertex in its chunk; each chunk's incidence runs
    hold each of its slots once; each vertex's partials are in chunk
    order; slots >= n_out have no partial."""
    tets, _, _, n_out = _plan_case(PLAN_CASES[name])
    C = tets.shape[0]
    plan = build_element_plan(torch.as_tensor(tets), n_out)
    local, inc = plan.local.numpy().astype(int), plan.inc.numpy().astype(int)
    off, gid = plan.chunk_off.numpy(), plan.gid.numpy()
    seg_end, pos = plan.seg_end.numpy().astype(int), plan.pos.numpy()
    vert_off = plan.vert_off.numpy()
    n_chunks = -(-C // CHUNK)
    assert off.shape == (n_chunks + 1,) and off[-1] == gid.size
    partial_of = {}                           # partial -> (vertex, chunk)
    hits = np.zeros(4 * C, int)
    for k in range(n_chunks):
        slots = np.arange(4 * k * CHUNK, min(4 * (k + 1) * CHUNK, 4 * C))
        ids = tets.reshape(-1)[slots]
        loc = gid[off[k]:off[k + 1]]
        assert np.array_equal(loc, np.unique(ids))     # sorted, distinct
        assert np.array_equal(loc[local.reshape(-1)[slots]], ids)
        run = inc[4 * k * CHUNK:4 * k * CHUNK + slots.size]
        assert np.array_equal(np.sort(run), np.arange(slots.size))
        begin = 0
        for j, lv in enumerate(range(off[k], off[k + 1])):
            members = run[begin:seg_end[lv]] + 4 * k * CHUNK
            assert np.all(tets.reshape(-1)[members] == loc[j])
            assert np.all(np.diff(members) > 0)        # slot order
            if loc[j] < n_out:
                assert 0 <= pos[lv] < plan.n_partials
                partial_of[int(pos[lv])] = (int(loc[j]), k)
                hits[members] += 1
            else:
                assert pos[lv] == -1
            begin = seg_end[lv]
        assert begin == slots.size
    kept = tets.reshape(-1) < n_out
    assert np.all(hits[kept] == 1) and np.all(hits[~kept] == 0)
    assert sorted(partial_of) == list(range(plan.n_partials))
    for v in range(n_out):
        owners = [partial_of[q] for q in range(vert_off[v], vert_off[v + 1])]
        assert all(w == v for w, _ in owners)
        chunks = [k for _, k in owners]
        assert chunks == sorted(set(chunks))           # chunk order


def test_element_plan_of_a_mesh_is_local():
    """In the mesh's own order (children written in place of their
    parent) a chunk's elements share vertices: well under one partial per
    element, where a chunk of unrelated elements would give ~4."""
    from repro_torch.fem import cylinder_mesh, uniform_refine
    mesh = cylinder_mesh(8, 2, length=4.0, radius=0.5)
    uniform_refine(mesh, 6)
    plan = build_element_plan(torch.as_tensor(mesh.tets).to(torch.int32),
                              mesh.n_verts)
    assert plan.n_partials < 0.6 * mesh.n_tets


# --- prefix_scan -------------------------------------------------------------
# Integer weights: every order of additions is exact below 2^24, so the
# scans are equal.  Float weights: the sums are taken in other orders, so
# each prefix agrees within 1e-6 of the total sum of |x|.

def _scan_case(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 5, n).astype(np.float32)
    return rng.random(n).astype(np.float32)


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("n", [1, 2047, 2048, 5000, 1 << 16])
def test_exclusive_scan_plain_matches_pallas_kernel(n, kind):
    x = _scan_case(n, kind, n)
    pallas = np.asarray(jops.exclusive_scan_op(jnp.asarray(x),
                                               use_pallas=True,
                                               interpret=True))
    oracle = np.asarray(jref.exclusive_scan_ref(jnp.asarray(x)))
    got = ops.exclusive_scan_op(torch.as_tensor(x), use_pallas=False)
    assert got.dtype == torch.float32 and got.shape == (n,)
    got = got.numpy()
    if kind == "int":
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, oracle)
    else:
        tol = 1e-6 * float(np.abs(x).sum())
        assert np.abs(got - pallas).max() <= tol
        assert np.abs(got - oracle).max() <= tol
    assert got[0] == 0.0


# --- dispatch ----------------------------------------------------------------

def _cpu_inputs():
    keys, w, cuts = _hist_case(100, 9, 0)
    tets, grads, vol, u = _matvec_case(20, 12, 12, 0)
    kel = fem_element_matrices(torch.as_tensor(grads), torch.as_tensor(vol))
    return (torch.as_tensor(_grid(50, 10, 0)), torch.as_tensor(keys),
            torch.as_tensor(w), torch.as_tensor(cuts), torch.as_tensor(tets),
            kel, torch.as_tensor(u))


def test_ops_on_cpu_run_plain_versions_with_no_launch():
    grid, keys, w, cuts, tets, kel, u = _cpu_inputs()
    q, kv = torch.zeros((1, 4, 8, 16)), torch.zeros((1, 2, 8, 16))
    seg = torch.tensor([0, 0, 0, 1, 1, -1, -1, -1], dtype=torch.int32)
    ops.reset_launch_counts()
    for use in (None, False):
        ops.sfc_keys_op(grid, use_pallas=use)
        ops.ksection_histogram_op(keys, w, cuts, use_pallas=use)
        ops.fem_matvec_op(tets, kel, u, 12, use_pallas=use)
        ops.flash_attention_op(q, kv, kv, use_pallas=use)
        ops.packed_attention_op(q[0], kv[0], kv[0], seg, use_pallas=use)
        ops.exclusive_scan_op(w, use_pallas=use)
        segment_sum_any_order(w, torch.arange(w.numel()) % 12, 12,
                              use_pallas=use)
    assert ops.launch_counts() == {"sfc_keys": 0, "ksection_hist": 0,
                                   "fem_matvec": 0, "prefix_scan": 0,
                                   "flash_attention": 0, "serve_prefill": 0,
                                   "segment_sum": 0}


def test_use_pallas_true_on_cpu_raises():
    grid, keys, w, cuts, tets, kel, u = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        ops.sfc_keys_op(grid, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ksection_histogram_op(keys, w, cuts, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fem_matvec_op(tets, kel, u, 12, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.exclusive_scan_op(w, use_pallas=True)
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_op(q, q, q, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.packed_attention_op(q[0], q[0], q[0],
                                torch.zeros(8, dtype=torch.int32),
                                use_pallas=True)


def test_kernel_wrappers_reject_cpu_tensors():
    grid, keys, w, cuts, tets, kel, u = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        sfc_keys_cuda(grid.to(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        ksection_hist_cuda(keys, w, cuts)
    with pytest.raises(ValueError, match="CUDA"):
        fem_matvec_cuda(tets, kel, u, 12)
    with pytest.raises(ValueError, match="CUDA"):
        exclusive_scan_cuda(w)
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        packed_attention_cuda(q[0], q[0], q[0],
                              torch.zeros(8, dtype=torch.int32))


def test_flash_attention_variants():
    """bf16 goes to the tensor-core kernel and float32 to the CUDA-core
    one, each with its own launch count beside the total."""
    from repro_torch.kernels.flash_attention import VARIANTS
    assert VARIANTS == {torch.bfloat16: "bf16_tensor_core",
                        torch.float32: "f32_cuda_core"}
    assert set(flash_attention_cuda.variants) == set(VARIANTS.values())
    flash_attention_cuda.variants["bf16_tensor_core"] = 3
    ops.reset_launch_counts()
    assert flash_attention_cuda.variants == {"bf16_tensor_core": 0,
                                             "f32_cuda_core": 0}
