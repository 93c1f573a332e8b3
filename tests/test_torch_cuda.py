"""The hand-written CUDA kernels on the card, against their plain versions.

Imports no JAX, so it runs on the machine with the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test carries the ``cuda`` marker, needs a CUDA device and skips
without one (the kernels have no CPU mode).  The plain versions are held against the JAX package in
test_torch_kernels.py, on the CPU.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.core import Balancer, BalanceSpec
from repro_torch.fem import AdaptiveSession, AdaptSpec, cylinder_mesh
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.fem_matvec import (build_element_plan,
                                            fem_element_matrices,
                                            fem_matvec_cuda)
from repro_torch.kernels.flash_attention import (VARIANTS,
                                                 flash_attention_cuda)
from repro_torch.kernels.ksection_hist import ksection_hist_cuda
from repro_torch.kernels.prefix_scan import exclusive_scan_cuda
from repro_torch.kernels.serve_prefill import packed_attention_cuda
from repro_torch.kernels.sfc_keys import sfc_keys_cuda
from repro_torch.telemetry import block_until_ready

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels)")
    return torch.device("cuda")


def _grid(n, bits, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1 << bits, (n, 3))
    top = (1 << bits) - 1
    g[:2] = [[0, 0, 0], [top, top, top]]
    return g


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("bits", [1, 5, 10])
def test_sfc_keys_kernel_equal(cuda, curve, bits):
    g = torch.as_tensor(_grid(100_003, bits, bits), device=cuda)
    before = sfc_keys_cuda.launches
    got = ops.sfc_keys_op(g, curve=curve, bits=bits)
    assert sfc_keys_cuda.launches == before + 1
    want = ops.sfc_keys_op(g, curve=curve, bits=bits, use_pallas=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,m", [(300_001, 8184), (5_000, 504), (1, 3),
                                 (10_000, 9_000)])
def test_ksection_hist_kernel_equal(cuda, n, m):
    rng = np.random.default_rng(n + m)
    keys = rng.integers(0, 1 << 20, n).astype(np.float32)
    w = rng.integers(0, 3, n).astype(np.float32)
    cuts = rng.integers(0, 1 << 20, m).astype(np.float32)
    k, ww, c = (torch.as_tensor(a, device=cuda) for a in (keys, w, cuts))
    got = ops.ksection_histogram_op(k, ww, c)
    assert torch.equal(got, ops.ksection_histogram_op(k, ww, c,
                                                      use_pallas=False))
    assert torch.equal(got, ksection_hist_cuda(k, ww, c))   # deterministic


def test_ksection_hist_kernel_empty(cuda):
    z = torch.zeros(0, device=cuda)
    assert ksection_hist_cuda(z, z, torch.ones(4, device=cuda)).tolist() == [0] * 4
    assert ksection_hist_cuda(torch.ones(4, device=cuda),
                              torch.ones(4, device=cuda), z).shape == (0,)


@pytest.mark.parametrize("C,V,n_out", [(100_000, 20_000, 19_999), (7, 5, 5),
                                       (0, 4, 4)])
def test_fem_matvec_kernel_close(cuda, C, V, n_out):
    rng = np.random.default_rng(C)
    tets = rng.integers(0, n_out + 1, (C, 4)).astype(np.int32)
    grads = torch.as_tensor(rng.standard_normal((C, 4, 3)).astype(np.float32),
                            device=cuda)
    vol = rng.random(C).astype(np.float32)
    vol[(tets == n_out).any(axis=1)] = 0.0
    kel = fem_element_matrices(grads, torch.as_tensor(vol, device=cuda), 1.0)
    t = torch.as_tensor(tets, device=cuda)
    u = torch.as_tensor(rng.standard_normal(V).astype(np.float32), device=cuda)
    got = fem_matvec_cuda(t, kel, u, n_out)
    want = ops.fem_matvec_op(t, kel, u, n_out, use_pallas=False)
    assert got.shape == want.shape == (n_out,)
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("C,V,n_out,pad_chunk", [(100_000, 20_000, 19_999,
                                                  False),
                                                 (3 * 256 + 5, 90, 80, True)])
def test_fem_matvec_kernel_bit_identical_across_calls(cuda, C, V, n_out,
                                                      pad_chunk):
    """No atomics: an operator's calls, and a fresh plan's, give the same
    bits; with an all-padding chunk and the pad slot read from V > n_out,
    within 1e-5 of max|y| of the plain version."""
    rng = np.random.default_rng(C + 1)
    tets = rng.integers(0, n_out + 1, (C, 4)).astype(np.int32)
    if pad_chunk:
        tets[256:512] = n_out
    vol = rng.random(C).astype(np.float32)
    vol[(tets == n_out).any(axis=1)] = 0.0
    grads = torch.as_tensor(rng.standard_normal((C, 4, 3)).astype(np.float32),
                            device=cuda)
    kel = fem_element_matrices(grads, torch.as_tensor(vol, device=cuda), 1.0)
    t = torch.as_tensor(tets, device=cuda)
    u = torch.as_tensor(rng.standard_normal(V).astype(np.float32), device=cuda)
    op = ops.ElementOperator(t, kel, n_out)
    before = fem_matvec_cuda.launches
    first = op.apply(u)
    assert fem_matvec_cuda.launches == before + 1
    assert torch.equal(first, op.apply(u))
    assert torch.equal(first, fem_matvec_cuda(t, kel, u, n_out))
    want = ref.fem_matvec_kel_ref(t, kel, u, n_out)
    scale = max(float(want.abs().max()), 1.0)
    assert float((first - want).abs().max()) <= 1e-5 * scale
    plan_y = ref.fem_matvec_plan_ref(build_element_plan(t, n_out), kel, u)
    assert float((first - plan_y).abs().max()) <= 1e-5 * scale


def test_fem_matvec_kernel_chunk_matches_the_plan(cuda):
    """The plan builder cuts the elements into the kernel's chunks."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fem_matvec import CHUNK
    assert build.library().repro_fem_matvec_chunk() == CHUNK


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError, match="int32"):
        sfc_keys_cuda(torch.zeros((4, 3), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        ksection_hist_cuda(torch.zeros(4, dtype=torch.float64, device=cuda),
                           torch.zeros(4, device=cuda), torch.zeros(2, device=cuda))
    with pytest.raises(ValueError, match="entries"):
        fem_matvec_cuda(torch.zeros((2, 4), dtype=torch.int32, device=cuda),
                        torch.zeros((2, 4, 4), device=cuda),
                        torch.zeros(3, device=cuda), 8)


# --- prefix scan -------------------------------------------------------------
# Integer weights whose total stays below 2^24: every order of additions
# is exact, so kernel and plain version are equal.  Float weights: within
# 1e-6 of the sum of |x| (other orders of additions), and the kernel gives
# the same bits on every run (no atomics).

SCAN_LENGTHS = [1, 4095, 4096, 4097, 1 << 19, (1 << 19) + 1, 1 << 22]


@pytest.mark.parametrize("n", [1, 31, 4095, 4096, 4097, 1_000_003, 1 << 19,
                               (1 << 19) + 1, 1 << 21, 1 << 22,
                               4096 * 1030 + 7])
def test_prefix_scan_kernel_exact_on_integers(cuda, n):
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.integers(0, 5, n).astype(np.float32),
                        device=cuda)
    before = exclusive_scan_cuda.launches
    got = exclusive_scan_cuda(x)
    assert exclusive_scan_cuda.launches == before + 1
    assert torch.equal(got, ref.exclusive_scan_ref(x))


def test_prefix_scan_kernel_float_close_and_deterministic(cuda):
    rng = np.random.default_rng(7)
    n = 2_588_188
    x = torch.as_tensor(rng.random(n).astype(np.float32), device=cuda)
    got = exclusive_scan_cuda(x)
    want = ref.exclusive_scan_ref(x.double())
    tol = 1e-6 * float(x.abs().sum())
    assert float((got.double() - want).abs().max()) <= tol
    assert torch.equal(got, exclusive_scan_cuda(x))
    assert exclusive_scan_cuda(x[:0]).shape == (0,)


@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_prefix_scan_kernel_float_close_and_repeats_at_lengths(cuda, n):
    rng = np.random.default_rng(n + 1)
    x = torch.as_tensor(rng.random(n).astype(np.float32), device=cuda)
    got = exclusive_scan_cuda(x)
    want = ref.exclusive_scan_ref(x.double())
    tol = 1e-6 * float(x.abs().sum())
    assert float((got.double() - want).abs().max()) <= tol
    for _ in range(3):
        assert torch.equal(got, exclusive_scan_cuda(x))


def test_prefix_scan_status_is_never_stale(cuda):
    """The kernel's per-tile flags live in a buffer kept per stream and
    told apart by a per-call epoch: alternating lengths (a long call
    leaves flags a short one must not read, and the other way round; both
    tile sizes) and a second stream give the same bits as fresh calls."""
    rng = np.random.default_rng(5)
    xs = [torch.as_tensor(rng.random(n).astype(np.float32), device=cuda)
          for n in (1 << 22, 4097, 1 << 19, 1, 2_588_188)]
    want = [exclusive_scan_cuda(x) for x in xs]
    side = torch.cuda.Stream()
    for _ in range(3):
        for x, w in zip(xs + xs[::-1], want + want[::-1]):
            assert torch.equal(exclusive_scan_cuda(x), w)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got = [exclusive_scan_cuda(x) for x in xs[::-1]]
        torch.cuda.current_stream().wait_stream(side)
        for g, w in zip(got, want[::-1]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1 << 19, 2_588_188])
def test_prefix_scan_is_one_launch(cuda, n):
    """One kernel and nothing else on the device per call, once the
    stream's status buffer exists.  The profiler has come back with
    device events missing, so a window that shows none is run again; one
    that shows more than one fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(n, device=cuda)
    out = torch.empty_like(x)
    exclusive_scan_cuda(x)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = exclusive_scan_cuda(x)
            torch.cuda.synchronize()
        on_device = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        assert len(on_device) <= 1, on_device
        if on_device:
            break
    assert len(on_device) == 1 and "scan" in on_device[0], on_device
    assert float(out[-1]) == n - 1


def test_prefix_scan_tile_matches_the_wrapper(cuda):
    from repro_torch.kernels import build
    from repro_torch.kernels.prefix_scan import SCAN_TILE
    assert build.library().repro_prefix_scan_tile() == SCAN_TILE


def test_prefix_scan_rejects_bad_inputs(cuda):
    with pytest.raises(ValueError, match="float32"):
        exclusive_scan_cuda(torch.zeros(4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        exclusive_scan_cuda(torch.zeros((2, 2), device=cuda))


def test_sharded_balancer_on_card_equals_host(cuda, tmp_path):
    """Four gloo ranks sharing the card (collectives staged through host
    memory): the sharded balance equals the host backend on the card, and
    its sorted stage ran the scan kernel."""
    from repro_torch.distributed import run_world
    out = run_world(_sharded_balance_rank, 4, 50_000,
                    init_file=str(tmp_path / "rdv"), devices=["cuda:0"] * 4,
                    timeout_s=120.0, join_s=300.0)
    for parts, host, launches, staged in out:
        np.testing.assert_array_equal(parts, host)
        assert launches > 0 and staged > 0


def _sharded_balance_rank(comm, n):
    rng = np.random.default_rng(3)
    coords = (rng.random((n, 3)) * [10.0, 1.0, 1.0]).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    spec = BalanceSpec(p=comm.size, method="hsfc", oneD="sorted",
                       backend="sharded")
    before = exclusive_scan_cuda.launches
    r = Balancer(spec, comm=comm).balance(w, coords=coords)
    launches = exclusive_scan_cuda.launches - before
    h = Balancer(spec.replace(backend="host"), device=comm.device).balance(
        w, coords=coords)
    return (r.parts.cpu().numpy(), h.parts.cpu().numpy(), launches,
            comm.staged_bytes)


@pytest.mark.parametrize("method,oneD", [("hsfc", "ksection"),
                                         ("msfc", "sorted"),
                                         ("rcb", "sorted")])
def test_balancer_kernels_equal_plain(cuda, method, oneD):
    rng = np.random.default_rng(1)
    n, p = 200_000, 128
    coords = (rng.random((n, 3)) * [10.0, 1.0, 1.0]).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    old = rng.integers(0, p, n)
    spec = BalanceSpec(p=p, method=method, oneD=oneD)
    a = Balancer(spec, device=cuda).balance(w, coords=coords, old_parts=old)
    b = Balancer(spec.replace(use_pallas=False), device=cuda).balance(
        w, coords=coords, old_parts=old)
    block_until_ready(a)
    for f in ("parts", "part_weights", "imbalance", "total_v", "max_v",
              "retained", "remap_perm"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.ksection_rounds == b.ksection_rounds


# The session on the card against the plain versions on the CPU, step by
# step on the card's own meshes.  Doerfler marking sorts float32
# indicators, and the cylinder mesh has groups of equal ones; the card's
# atomic sums change their last bits from run to run, so the card may mark
# another member of a tie group than the CPU, after which two whole
# sessions refine different meshes.  So each card step is replayed on the
# CPU as a one-step session from a copy of the mesh it solved on: cg
# iterations within 2, err_l2 and total eta within SESSION_RTOL, and the
# same marks up to ties (an element marked on one side only has the
# smallest marked indicator, within TIE_RTOL).
SESSION_RTOL = 1e-4
TIE_RTOL = 1e-3


def _keep(into, meshes=None):
    def on_step(stats, state):
        into.append((stats, state.marked.copy(), state.eta.copy()))
        if meshes is not None:          # the mesh the next step solves on
            meshes.append(copy.deepcopy(state.mesh))
    return on_step


def test_session_on_card_launches_all_kernels_and_tracks_cpu(cuda):
    spec = AdaptSpec.for_problem(
        "helmholtz", max_steps=3, max_tets=6000, tol=1e-6, incremental=True,
        trigger="always", balance=BalanceSpec(p=16, oneD="ksection"))
    mesh = cylinder_mesh(8, 2, length=4.0, radius=0.5)
    solved_on, card = [copy.deepcopy(mesh)], []
    ops.reset_launch_counts()
    a = AdaptiveSession(spec, device=cuda,
                        on_step=_keep(card, solved_on)).run(mesh)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("sfc_keys", "ksection_hist",
                                       "fem_matvec"))
    assert len(card) == spec.max_steps
    n_repartitions = 0
    for step, (sa, marked_a, _) in enumerate(card):
        cpu = []
        b = AdaptiveSession(spec.replace(max_steps=1), device="cpu",
                            on_step=_keep(cpu)).run(solved_on[step])
        n_repartitions += b.n_repartitions
        sb, marked_b, eta_b = cpu[0]
        assert abs(sa.cg_iters - sb.cg_iters) <= 2, step
        assert abs(sa.err_l2 - sb.err_l2) <= SESSION_RTOL * sb.err_l2, step
        assert abs(sa.eta - sb.eta) <= SESSION_RTOL * sb.eta, step
        differ = np.flatnonzero(marked_a != marked_b)
        edge = eta_b[marked_b].min()
        assert np.all(np.abs(eta_b[differ] - edge) <= TIE_RTOL * edge), (
            step, differ)
    assert a.n_repartitions == n_repartitions


# --- sums in a fixed order ----------------------------------------------------
# On the card segment_sum adds each segment's contributions in an order
# fixed by the ids (repro_torch.segment.SegmentOrder): the FEM's sums give
# the same bits on every call, so whole sessions repeat bit for bit.
# Against the CPU's index_add_ on the same elements: float32 sums in
# another order, within 1e-5 of the largest value (1e-4 for the
# estimator, whose recovered gradient is differenced).

def _random_elements(n_tets, seed):
    """Elements of a random tet mesh of ``n_tets`` (the FEM session's
    786,432): uniform vertices in the unit cube, 5.6 tets per vertex as
    in the refined cylinder, numbered in Morton order of a 64^3 grid so
    that each tet's 4 distinct vertices, close in number, lie close in
    space (small tets, as in a refined mesh)."""
    from repro_torch.core.sfc import morton_encode
    from repro_torch.fem import build_elements
    rng = np.random.default_rng(seed)
    nv = int(n_tets / 5.6)
    verts = rng.random((nv, 3))
    cells = torch.as_tensor((verts * 64).astype(np.int64))
    verts = verts[np.argsort(morton_encode(cells, 6).numpy(), kind="stable")]
    base = rng.integers(0, nv, n_tets)
    steps = rng.integers(1, 20, (n_tets, 3)).cumsum(axis=1)
    tets = np.concatenate([base[:, None], (base[:, None] + steps) % nv],
                          axis=1).astype(np.int32)
    return verts.astype(np.float32), build_elements(verts, tets,
                                                    device="cpu")


def test_fem_sums_repeat_bits_on_card(cuda):
    """The load vector, diagonal, mass matvec and estimator on the card
    give the same bits on two calls, and agree with the CPU's; the
    fixed-order sum alone, on the card's own contributions, agrees with
    the CPU's index_add_ within 1e-5 of each vertex's sum of |x|."""
    from repro_torch.fem import (HelmholtzProblem, load_vector, mass_matvec,
                                 operator_diagonal, zz_estimate)
    from repro_torch.fem.assemble import P1Elements
    from repro_torch.segment import segment_sum, segment_sum_any_order
    verts, el_cpu = _random_elements(786_432, 0)
    el = P1Elements(*(t.to(cuda) for t in el_cpu[:3]), el_cpu.n_verts)
    u = np.random.default_rng(1).standard_normal(el.n_verts).astype(
        np.float32)
    prob = HelmholtzProblem()

    def sums(e, dev):
        tu = torch.as_tensor(u, device=dev)
        tv = torch.as_tensor(verts, device=dev)
        return {"load_vector": load_vector(e, tv, prob.f),
                "operator_diagonal": operator_diagonal(e, 1.0),
                "mass_matvec": mass_matvec(e, tu),
                "zz_estimate": zz_estimate(e, tu)}

    first, second, cpu = sums(el, cuda), sums(el, cuda), sums(el_cpu, "cpu")
    errs = {}
    for name, got in first.items():
        assert torch.equal(got, second[name]), name
        want = cpu[name]
        errs[name] = float((got.cpu() - want).abs().max()) / float(
            want.abs().max())
    assert all(e <= (1e-4 if name == "zz_estimate" else 1e-5)
               for name, e in errs.items()), errs
    ids = el.tets.reshape(-1)
    x = torch.repeat_interleave(el.vol, 4) * torch.randn(
        ids.numel(), device=cuda)
    got = segment_sum(x, ids, el.n_verts)
    assert torch.equal(got, segment_sum(x, ids, el.n_verts))
    want = segment_sum_any_order(x.cpu(), ids.cpu(), el.n_verts)
    abs_sum = segment_sum_any_order(x.abs().cpu(), ids.cpu(), el.n_verts)
    assert bool(((got.cpu() - want).abs() <= 1e-5 * abs_sum).all())


def test_halo_finish_repeats_bits_on_card(cuda):
    """halo_finish adds leg 1 through the fixed-order sum: one part whose
    exchange returns what it is given, 200k slots, 150k contributions of
    which many land on a slot with others; every ghost slot once."""
    from repro_torch.fem.halo import halo_finish

    class OneRank:
        def all_to_all(self, x):
            return x

    class Done:
        def __init__(self, x):
            self.x = x

        def wait(self):
            return self.x

    rng = np.random.default_rng(3)
    V, H = 200_000, 150_000
    y = torch.as_tensor(rng.standard_normal(V).astype(np.float32),
                        device=cuda)
    recv = torch.as_tensor(rng.integers(0, V + 1, (1, H)), device=cuda)
    send = torch.as_tensor(rng.permutation(V + 1)[None, :H],
                           device=cuda)
    contrib = torch.as_tensor(rng.standard_normal(H).astype(np.float32),
                              device=cuda)
    contrib = torch.where(recv[0] < V, contrib, 0.0)
    args = (y, Done(contrib), send, recv, OneRank())
    first = halo_finish(*args)
    assert torch.equal(first, halo_finish(*args))
    want = halo_finish(*(a.cpu() if torch.is_tensor(a) else a
                         for a in (y, Done(contrib.cpu()), send, recv,
                                   OneRank())))
    assert float((first.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_small_sessions_on_card_repeat_bit_for_bit(cuda):
    """Two smoke-size sessions on the card: equal n_tets, err_l2, eta and
    marks at every step."""
    spec = AdaptSpec.for_problem(
        "helmholtz", max_steps=3, max_tets=6000, tol=1e-6, incremental=True,
        balance=BalanceSpec(p=16, method="hsfc", oneD="ksection"))
    runs = []
    for _ in range(2):
        steps = []
        AdaptiveSession(spec, device=cuda, on_step=lambda st, s: steps.append(
            (st.n_tets, st.err_l2, st.eta, st.cg_iters, s.marked.copy(),
             s.eta.copy()))).run(cylinder_mesh(8, 2, length=4.0, radius=0.5))
        runs.append(steps)
    assert len(runs[0]) == len(runs[1]) == spec.max_steps
    for step, (a, b) in enumerate(zip(*runs)):
        assert a[:4] == b[:4], step
        np.testing.assert_array_equal(a[4], b[4])
        np.testing.assert_array_equal(a[5], b[5])


# --- attention kernels -------------------------------------------------------
# Tolerances: float32 inputs agree with the plain version to float32
# rounding of differently ordered sums (2e-5 of the output scale).  Both
# sides round a bf16 output once from float32, so each element may differ
# by one bf16 step (at most 2**-7 of its value), plus float32 rounding
# where the value is near 0 (1e-3).

def _assert_close(got, want, dtype):
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        scale = max(float(want.float().abs().max()), 1.0)
        assert float(diff.max()) <= 2e-5 * scale, float(diff.max())
    else:
        limit = 2.0 ** -7 * want.float().abs() + 1e-3
        assert bool((diff <= limit).all()), float((diff / limit).max())


def _qkv(rng, qshape, kshape, dtype, device):
    return tuple(torch.as_tensor(rng.standard_normal(sh).astype(np.float32),
                                 device=device).to(dtype)
                 for sh in (qshape, kshape, kshape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 32, 8, 1024, 128, True, None),     # the full prefill's shape
    (2, 4, 2, 77, 16, True, None),         # ragged s, GQA, SMOKE head dim
    (1, 4, 4, 200, 64, False, None),       # no mask
    (1, 6, 2, 130, 100, True, 40),         # window, d not a multiple of 32
    (1, 2, 1, 1, 8, True, None),           # one token
    (1, 4, 1, 96, 32, False, 17),          # window without causal
    (1, 8, 2, 300, 120, True, 64),         # danube3's head dim, a window
    (1, 8, 2, 300, 80, True, 64),          # danube-1.8b's head dim
    (1, 24, 2, 200, 128, True, None),      # command-r's GQA group of 12
    (1, 10, 1, 300, 256, True, 64),        # recurrentgemma's MQA of 10, d 256
    (1, 10, 1, 2300, 256, True, 2048),     # its window of 2048, passed
    (2, 3, 3, 77, 200, False, None),       # 128 < d < 256, ragged
])
def test_flash_attention_kernel_close(cuda, dtype, b, hq, hkv, s, d, causal,
                                      window):
    rng = np.random.default_rng(s + d)
    q, k, v = _qkv(rng, (b, hq, s, d), (b, hkv, s, d), dtype, cuda)
    before = flash_attention_cuda.launches
    variant = flash_attention_cuda.variants[VARIANTS[dtype]]
    got = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    assert flash_attention_cuda.launches == before + 1
    assert flash_attention_cuda.variants[VARIANTS[dtype]] == variant + 1
    want = ref.mha_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (16, 16, 16, 1, 1500, 64),     # whisper's cross-attention at decode
    (2, 16, 16, 128, 1500, 64),    # ... at prefill (fewer rows than 16)
    (1, 16, 16, 1500, 1500, 64),   # the encoder's self-attention, no mask
    (1, 4, 2, 300, 77, 32),        # fewer keys than queries, GQA
    (2, 4, 4, 65, 129, 16),        # ragged query and key tiles
    (1, 8, 2, 3, 1, 128),          # one key
])
def test_flash_attention_cross_lengths_close(cuda, dtype, b, hq, hkv, sq,
                                             skv, d):
    """K/V of another length than Q, without a mask (cross-attention):
    each element against mha_ref, whose mask takes both lengths."""
    rng = np.random.default_rng(sq * 3 + skv)
    q, k, v = _qkv(rng, (b, hq, sq, d), (b, hkv, skv, d), dtype, cuda)
    before = flash_attention_cuda.variants[VARIANTS[dtype]]
    got = ops.flash_attention_op(q, k, v, causal=False)
    assert flash_attention_cuda.variants[VARIANTS[dtype]] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, ref.mha_ref(q, k, v, causal=False), dtype)


def test_flash_attention_refuses_cross_lengths_with_a_mask(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    kv = torch.zeros((1, 2, 20, 16), device=cuda)
    before = flash_attention_cuda.launches
    for kw in (dict(causal=True), dict(causal=False, window=4),
               dict(causal=True, window=4)):
        with pytest.raises(ValueError, match="cross-attention"):
            flash_attention_cuda(q, kv, kv, **kw)
    assert flash_attention_cuda.launches == before


def test_flash_attention_path_shape_runs_on_tensor_cores(cuda):
    """The full prefill's shape on the serving path (32 / 8 heads, d = 128,
    a 128-token prompt, causal, bf16) runs the tensor-core kernel."""
    rng = np.random.default_rng(128)
    q, k, v = _qkv(rng, (1, 32, 128, 128), (1, 8, 128, 128), torch.bfloat16,
                   cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention_op(q, k, v, causal=True)
    assert flash_attention_cuda.variants == {"bf16_tensor_core": 1,
                                             "f32_cuda_core": 0}
    _assert_close(got, ref.mha_ref(q, k, v, causal=True), torch.bfloat16)


def _pack(rng, C, lengths, gap):
    """Segment ids for requests of ``lengths`` packed in order, each
    followed by ``gap`` pad tokens; the tail is pad."""
    seg = np.full(C, -1, np.int32)
    off = 0
    for sid, ln in enumerate(lengths):
        seg[off:off + ln] = sid
        off += ln + gap
    return seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,hq,hkv,d,lengths,gap,softcap", [
    (2048, 32, 8, 128, (1024, 512, 256, 128, 100), 12, None),
    (100, 4, 2, 16, (3, 50, 9), 1, None),          # ragged C, pad gaps
    (256, 4, 1, 64, (200,), 0, 30.0),             # softcap, GQA 4:1
    (130, 2, 2, 48, (1, 1, 70), 3, 5.0),
    (64, 2, 1, 16, (), 0, None),                  # all pad
    (2048, 32, 8, 128, (128,) * 7, 0, None),      # the path's fullest buffer
    (2048, 32, 8, 128, (1024, 512, 256, 128, 128), 0, None),   # full buffer
    (2048, 4, 1, 64, (700, 300), 16, 20.0),       # GQA 4:1, d 64, softcap
    (300, 4, 1, 100, (37, 90, 64, 20), 5, 50.0),  # d % 8 != 0, ragged C
    (1000, 8, 2, 128, (1000,), 0, None),          # one request, ragged C
    (200, 8, 2, 72, (63, 65, 1, 40), 0, None),    # requests straddle tiles
    (513, 4, 4, 128, (64, 64, 64), 130, 10.0),    # pad-only tiles between
    (512, 8, 2, 80, (200, 100, 150), 4, None),    # d 80 (danube-1.8b)
    (512, 8, 2, 80, (300, 190), 0, 30.0),         # d 80 with a soft cap
    (2048, 48, 8, 128, (128,) * 7, 0, 30.0),      # grok's heads and cap
])
def test_packed_attention_kernel_close(cuda, dtype, C, hq, hkv, d, lengths,
                                       gap, softcap):
    rng = np.random.default_rng(C + d)
    q, k, v = _qkv(rng, (hq, C, d), (hkv, C, d), dtype, cuda)
    seg = torch.as_tensor(_pack(rng, C, lengths, gap), device=cuda)
    before = packed_attention_cuda.launches
    got = ops.packed_attention_op(q, k, v, seg, softcap=softcap)
    assert packed_attention_cuda.launches == before + 1
    want = ref.packed_attention_ref(q, k, v, seg, softcap=softcap)
    _assert_close(got, want, dtype)
    pad = seg < 0
    assert bool((got[:, pad] == 0).all())       # pad rows exactly 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_kernel_any_layout(cuda, dtype):
    """Requests interleaved token by token (no order a search could use):
    the key-tile ranges only over-approximate, so the result stays
    right."""
    rng = np.random.default_rng(9)
    C, hq, hkv, d = 300, 4, 2, 64
    q, k, v = _qkv(rng, (hq, C, d), (hkv, C, d), dtype, cuda)
    seg = torch.as_tensor(rng.integers(-1, 5, C).astype(np.int32),
                          device=cuda)
    got = ops.packed_attention_op(q, k, v, seg, softcap=15.0)
    _assert_close(got, ref.packed_attention_ref(q, k, v, seg, softcap=15.0),
                  dtype)
    assert bool((got[:, seg < 0] == 0).all())


def test_packed_attention_bf16_on_tensor_cores_repeats_bits(cuda):
    """The packed trace's shape (32 / 8 heads, d = 128, 7 x 128 tokens in
    a 2,048 buffer, bf16) runs the tensor-core kernel and gives the same
    bits on every call; float32 runs the CUDA-core one."""
    rng = np.random.default_rng(2048)
    C, hq, hkv, d = 2048, 32, 8, 128
    q, k, v = _qkv(rng, (hq, C, d), (hkv, C, d), torch.bfloat16, cuda)
    seg = torch.as_tensor(_pack(rng, C, (128,) * 7, 0), device=cuda)
    ops.reset_launch_counts()
    first = ops.packed_attention_op(q, k, v, seg)
    assert packed_attention_cuda.variants == {"bf16_tensor_core": 1,
                                              "f32_cuda_core": 0}
    for _ in range(2):
        assert torch.equal(first, ops.packed_attention_op(q, k, v, seg))
    ops.packed_attention_op(q[:, :64].float().contiguous(),
                            k[:, :64].float().contiguous(),
                            v[:, :64].float().contiguous(), seg[:64])
    assert packed_attention_cuda.variants == {"bf16_tensor_core": 3,
                                              "f32_cuda_core": 1}


def test_attention_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q, torch.zeros((1, 3, 8, 16), device=cuda),
                             torch.zeros((1, 3, 8, 16), device=cuda))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 1, 8, 257), device=cuda)
        flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="head dim"):
        d256 = torch.zeros((1, 8, 256), device=cuda)
        packed_attention_cuda(d256, d256, d256,
                              torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="int32"):
        packed_attention_cuda(q[0], q[0], q[0],
                              torch.zeros(8, dtype=torch.int64, device=cuda))


def test_refused_flash_launch_raises(cuda):
    """A launch the C entry refuses returns its CUDA error, and the wrapper
    raises on it (a head dim above 256 never reaches a kernel)."""
    from repro_torch.kernels import build
    lib = build.library()
    x = torch.zeros((1, 1, 8, 300), dtype=torch.bfloat16, device=cuda)
    o = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    for entry in (lib.repro_flash_attention_tc, lib.repro_flash_attention):
        for s_kv, d, causal in ((8, 300, 1), (5, 8, 1)):
            err = entry(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                        o.data_ptr(), 1, 1, 1, 8, s_kv, d, 1.0, causal, 0,
                        stream)
            assert err != 0
            with pytest.raises(RuntimeError, match="CUDA error"):
                build.check(err, "flash_attention")


def test_flash_attention_head_dim_256_runs_on_tensor_cores(cuda):
    """recurrentgemma's prefill shape (10 / 1 heads, d = 256, window 2048,
    a prompt past the window) runs the bf16 tensor-core kernel and
    repeats its bits."""
    rng = np.random.default_rng(256)
    q, k, v = _qkv(rng, (1, 10, 2500, 256), (1, 1, 2500, 256),
                   torch.bfloat16, cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention_op(q, k, v, causal=True, window=2048)
    again = ops.flash_attention_op(q, k, v, causal=True, window=2048)
    assert flash_attention_cuda.variants == {"bf16_tensor_core": 2,
                                             "f32_cuda_core": 0}
    assert torch.equal(got, again)
    _assert_close(got, ref.mha_ref(q, k, v, causal=True, window=2048),
                  torch.bfloat16)


# --- the serving path on the card --------------------------------------------
# float32 at the smoke size, the same weights on both sides: the card runs
# the kernels, the CPU the plain versions; logits agree to 1e-4 of their
# largest value (float32 sums in other orders).

def _smoke_models(cuda):
    import copy
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    cfg = get_smoke("llama3_8b").replace(use_pallas=True)
    cpu = init_model(cfg, seed=0, device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(cuda)


def test_prefills_on_card_match_cpu(cuda):
    from repro_torch.serve import decode
    cfg, cpu, card = _smoke_models(cuda)
    rng = np.random.default_rng(2)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 37)))
    before = flash_attention_cuda.launches
    lc, kc = decode.decoder_prefill(card, tok.to(cuda), cfg, max_seq=64)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    lp, kp = decode.decoder_prefill(cpu, tok, cfg, max_seq=64)
    err = float((lc.cpu() - lp).abs().max())
    assert err <= 1e-4 * float(lp.abs().max()), err
    assert torch.allclose(kc.k.cpu(), kp.k, atol=1e-5)
    C = 96
    seg = np.full(C, -1, np.int32)
    pos = np.zeros(C, np.int32)
    for sid, (off, ln) in enumerate([(0, 30), (32, 17), (64, 25)]):
        seg[off:off + ln] = sid
        pos[off:off + ln] = np.arange(ln)
    last = torch.as_tensor([29, 48, 88])
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, C))
    args = [torch.as_tensor(a) for a in (seg, pos)]
    before = packed_attention_cuda.launches
    lc, ksc, _ = decode.packed_prefill(card, toks.to(cuda),
                                       *(a.to(cuda) for a in args),
                                       last.to(cuda), cfg)
    assert packed_attention_cuda.launches == before + cfg.n_layers
    lp, ksp, _ = decode.packed_prefill(cpu, toks, *args, last, cfg)
    err = float((lc.cpu() - lp).abs().max())
    assert err <= 1e-4 * float(lp.abs().max()), err
    assert torch.allclose(ksc.cpu(), ksp, atol=1e-5)


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = x.double().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def test_mlp_bf16_on_card_rounds_once_like_the_cpu(cuda):
    """bf16 operands go straight into float32 products on the card
    (``torch.mm(..., out_dtype=float32)``); the CPU upcasts them.  x.wg
    and x.wi agree to 1e-5 of their largest value (a product rounded to
    bf16 is ~2^-9 off); wo's product of the card's activation, rounded
    once, is within one bf16 step per element of the CPU's (or 2^-16 of
    the largest output, where cancellation leaves an element near 0 and
    float32 sums in another order differ by more than its step); and
    ``mlp_apply`` on the card is exactly that composition."""
    import torch.nn.functional as F
    from repro_torch.configs import get_smoke
    from repro_torch.models import layers
    cfg = get_smoke("llama3_8b").replace(d_model=256, d_ff=1024,
                                         dtype="bfloat16",
                                         param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(14)
    cpu = layers.MLP(cfg, "cpu", gen)
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn((2, 9, cfg.d_model), generator=gen).to(torch.bfloat16)
    prods = []
    for w in ("wg", "wi"):
        got = layers.matmul_f32(x.to(cuda), getattr(card, w))
        want = layers.matmul_f32(x, getattr(cpu, w))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got.cpu() - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        prods.append(got)
    assert card.wi.dtype == torch.bfloat16
    h = (F.silu(prods[0]) * prods[1]).to(torch.bfloat16)
    got = layers.matmul_f32(h, card.wo).to(torch.bfloat16)
    want = layers.matmul_f32(h.cpu(), cpu.wo).to(torch.bfloat16)
    diff = (got.cpu().double() - want.double()).abs()
    tol = torch.maximum(_bf16_step(want),
                        2.0 ** -16 * want.double().abs().max())
    assert bool((diff <= tol).all()), (int((diff > tol).sum()),
                                       float(diff.max()))
    full = layers.mlp_apply(card, x.to(cuda), cfg)
    assert full.dtype == torch.bfloat16 and torch.equal(full, got)


@pytest.mark.parametrize("prefill", ["packed", "full"])
def test_serve_session_on_card_matches_cpu(cuda, prefill):
    from repro_torch.serve import ServeSession, ServeSpec, bursty_trace, run_trace
    cfg, cpu, card = _smoke_models(cuda)
    kw = dict(slots=8, groups=4, max_seq=128, prefill=prefill,
              prefill_capacity=128, page_size=16, decode="replicated",
              rebalance="tags", rebalance_every=4)
    outs, logs = [], []
    for model, dev in ((card, cuda), (cpu, "cpu")):
        sess = ServeSession(model, cfg, ServeSpec(**kw), device=dev)
        reqs, submit = [], sess.submit
        sess.submit = lambda r: (reqs.append(r), submit(r))[1]
        ops.reset_launch_counts()
        m = run_trace(sess, bursty_trace(16, seed=3, vocab=cfg.vocab,
                                         prompt_buckets=(8, 16, 32),
                                         max_new_cap=12))
        if dev != "cpu":
            # the SSM path runs no attention: its kernel is the balancer's
            name = ("serve_prefill" if prefill == "packed" else
                    "ksection_hist" if cfg.family == "ssm" else
                    "flash_attention")
            assert ops.launch_counts()[name] > 0
        outs.append([r.out for r in reqs])
        logs.append(m["migration_log"])
    assert outs[0] == outs[1]
    assert logs[0] == logs[1]


# --- the MoE layer and the other architectures on the card --------------------

def _moe_pair(cuda, dtype):
    """An MoE layer of phi3.5-moe SMOKE's shape (16 experts, top 2) with
    seeded weights on the CPU and a copy on the card; capacity 0.5 drops
    items."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.moe import MoE
    cfg = get_smoke("phi35_moe_42b").replace(dtype=dtype, param_dtype=dtype,
                                             capacity_factor=0.5)
    cpu = MoE(cfg, "cpu", torch.Generator().manual_seed(31))
    return cfg, cpu, copy.deepcopy(cpu).to(cuda)


def test_moe_apply_float32_on_card_matches_cpu(cuda):
    """Routing, dispatch and the expert products on the card equal the CPU's
    within float32 rounding (1e-5 of the largest output), with the same
    expert choices."""
    from repro_torch.models import moe
    cfg, cpu, card = _moe_pair(cuda, "float32")
    x = torch.randn((3, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(32))
    gc, ic, _ = moe._route(card, x.to(cuda), cfg)
    gp, ip, _ = moe._route(cpu, x, cfg)
    assert torch.equal(ic.cpu(), ip)
    got, aux = moe.moe_apply(card, x.to(cuda), cfg)
    want, aux_cpu = moe.moe_apply(cpu, x, cfg)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5


def test_moe_apply_bf16_on_card_matches_cpu(cuda):
    """bf16 expert weights go straight into float32 products on the card
    (``torch.bmm(..., out_dtype=float32)``); the CPU upcasts them.  The
    router is float32 on both sides, so the experts, slots and keep flags
    are equal; each expert product within 1e-5 of its largest value; the
    layer's output within 0.02 of its largest |value| (an activation
    rounded to the neighbouring bf16 value on one side moves an output
    near 0 by more than its own step)."""
    from repro_torch.models import layers, moe
    cfg, cpu, card = _moe_pair(cuda, "bfloat16")
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(33)).to(torch.bfloat16)
    _, ic, _ = moe._route(card, x.to(cuda), cfg)
    _, ip, _ = moe._route(cpu, x, cfg)
    assert torch.equal(ic.cpu(), ip)
    cap = max(int(cfg.capacity_factor * 64 * cfg.top_k / cfg.n_experts), 1)
    sc, kc = moe._dispatch_indices(ic.reshape(2, -1), cfg.n_experts, cap)
    sp, kp = moe._dispatch_indices(ip.reshape(2, -1), cfg.n_experts, cap)
    assert torch.equal(sc.cpu(), sp) and torch.equal(kc.cpu(), kp)
    assert not bool(kp.all())
    xe = x[0, :32].expand(cfg.n_experts, 32, cfg.d_model).contiguous()
    got = layers.bmm_f32(xe.to(cuda), card.wi)
    want = layers.bmm_f32(xe, cpu.wi)
    assert got.dtype == torch.float32
    assert float((got.cpu() - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    out, _ = moe.moe_apply(card, x.to(cuda), cfg)
    ref, _ = moe.moe_apply(cpu, x, cfg)
    assert out.dtype == torch.bfloat16
    err = float((out.cpu().float() - ref.float()).abs().max())
    assert err <= 0.02 * float(ref.float().abs().max()), err


@pytest.mark.parametrize("arch,prefill,buckets", [
    ("phi35_moe_42b", "packed", (8, 16, 32)),
    ("grok_1_314b", "packed", (8, 16, 32)),
    ("h2o_danube3_4b", "full", (48, 64, 96)),      # prompts wrap the ring
    ("mamba2_1_3b", "full", (8, 16, 32)),
    ("recurrentgemma_2b", "full", (48, 64, 96)),   # prompts wrap the ring
    ("whisper_medium", "cheap", (8, 16, 32)),      # cross-attention at decode
    ("qwen2_vl_72b", "full", (8, 16, 32)),         # M-RoPE prefill
])
def test_serve_session_on_card_matches_cpu_at_smoke(cuda, arch, prefill,
                                                     buckets):
    """The other families' SMOKE sessions in float32, the kernels on the
    card against the plain versions on the CPU: the same tokens and
    rebalances."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    from repro_torch.serve import (ServeSession, ServeSpec, bursty_trace,
                                   run_trace)
    cfg = get_smoke(arch).replace(use_pallas=True)
    cpu = init_model(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    kw = dict(slots=8, groups=4, max_seq=128, prefill=prefill,
              prefill_capacity=128, page_size=16, decode="replicated",
              rebalance="tags", rebalance_every=4)
    outs, logs = [], []
    for model, dev in ((card, cuda), (cpu, "cpu")):
        sess = ServeSession(model, cfg, ServeSpec(**kw), device=dev)
        reqs, submit = [], sess.submit
        sess.submit = lambda r: (reqs.append(r), submit(r))[1]
        ops.reset_launch_counts()
        m = run_trace(sess, bursty_trace(12, seed=1, vocab=cfg.vocab,
                                         prompt_buckets=buckets,
                                         max_new_cap=16))
        if dev != "cpu":
            # the SSM path runs no attention: its kernel is the balancer's
            name = ("serve_prefill" if prefill == "packed" else
                    "ksection_hist" if cfg.family == "ssm" else
                    "flash_attention")
            assert ops.launch_counts()[name] > 0
        outs.append([r.out for r in reqs])
        logs.append(m["migration_log"])
    assert outs[0] == outs[1]
    assert logs[0] == logs[1]


def test_encdec_prefill_and_decode_on_card_match_cpu(cuda):
    """whisper's batch API at SMOKE in float32: the encoder (non-causal),
    the decoder (causal) and the cross-attention (64 frames) run the flash
    kernel on the card, 3 launches a layer at prefill and one a decode
    step; logits within 1e-4 of the CPU's largest."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    from repro_torch.serve import decode
    cfg = get_smoke("whisper_medium").replace(use_pallas=True)
    cpu = init_model(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    g = torch.Generator().manual_seed(5)
    frames = torch.randn((3, cfg.enc_seq, cfg.d_model), generator=g)
    tokens = torch.randint(0, cfg.vocab, (3, 9), generator=g)
    ops.reset_launch_counts()
    got, gs = decode.prefill(card, {"frames": frames.to(cuda),
                                    "tokens": tokens.to(cuda)}, cfg,
                             max_seq=32)
    assert flash_attention_cuda.launches == cfg.enc_layers + 2 * cfg.n_layers
    want, ws = decode.prefill(cpu, {"frames": frames, "tokens": tokens}, cfg,
                              max_seq=32)
    tok = torch.argmax(want, dim=-1)[:, None]
    for _ in range(4):
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        before = flash_attention_cuda.launches
        got, gs = decode.decode_step(card, gs, tok.to(cuda), cfg)
        assert flash_attention_cuda.launches == before + cfg.n_layers
        want, ws = decode.decode_step(cpu, ws, tok, cfg)
        tok = torch.argmax(want[:, -1], dim=-1)[:, None]
    assert float((got.cpu() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())


# --- the redesigned histogram and SFC keys -------------------------------------
# The histogram ranks the cuts, buckets every item by a search over them and
# adds in an order fixed by the inputs: equal to the plain version on integer
# weights, the same bits on every call on float weights.

def _hist_inputs(n, m, seed, cuda, *, floats=False, dup=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, n).astype(np.float32)
    w = (rng.random(n) if floats else rng.integers(0, 3, n)).astype(np.float32)
    cuts = rng.integers(0, 1 << 20, m).astype(np.float32)
    if dup and m > 16:
        cuts[: m // 2] = np.repeat(cuts[: m // 16 + 1], 8)[: m // 2]  # boxes
    if m and n:
        cuts[::7] = keys[rng.integers(0, n, len(cuts[::7]))]     # cut == key
    if n > 64:
        keys[-50:] = np.inf                                      # padded tail
        w[-50:] = 0.0
    return tuple(torch.as_tensor(a, device=cuda) for a in (keys, w, cuts))


@pytest.mark.parametrize("n,m", [(1 << 21, 504), (1 << 21, 8184),
                                 (100_000, 40_000)])
def test_ksection_hist_same_bits_on_floats(cuda, n, m):
    k, w, c = _hist_inputs(n, m, 1, cuda, floats=True)
    first = ksection_hist_cuda(k, w, c)
    assert all(torch.equal(first, ksection_hist_cuda(k, w, c))
               for _ in range(3))
    want = ref.ksection_histogram_ref(k, w, c)
    assert float((first - want).abs().max()) <= 1e-6 * float(w.abs().sum())


@pytest.mark.parametrize("n,m", [(1 << 23, 8184), (2_097_152, 504),
                                 (300_000, 40_000), (50_000, 16_385)])
def test_ksection_hist_equal_on_integers_with_duplicate_cuts(cuda, n, m):
    k, w, c = _hist_inputs(n, m, n + m, cuda, dup=True)
    got = ksection_hist_cuda(k, w, c)
    assert torch.equal(got, ref.ksection_histogram_ref(k, w, c))
    assert torch.equal(got, ksection_hist_cuda(k, w, c))


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1023, 1025, 4097,
                               100_003])
@pytest.mark.parametrize("m", [1, 504, 9000])
def test_ksection_hist_tails(cuda, n, m):
    k, w, c = _hist_inputs(n, m, n * 3 + m, cuda)
    assert torch.equal(ksection_hist_cuda(k, w, c),
                       ref.ksection_histogram_ref(k, w, c))


def test_ksection_hist_sorted_keys_and_misaligned_input(cuda):
    """Keys in order (every lane of a warp in one bucket) and keys /
    weights that start 4 bytes into their storage."""
    k, w, c = _hist_inputs(1_000_001, 8184, 5, cuda)
    k = torch.sort(k).values
    want = ref.ksection_histogram_ref(k[1:], w[1:], c)
    assert k[1:].data_ptr() % 16 != 0
    assert torch.equal(ksection_hist_cuda(k[1:], w[1:], c), want)
    assert torch.equal(ksection_hist_cuda(k, w, c),
                       ref.ksection_histogram_ref(k, w, c))


def test_ksection_hist_counts_one_launch_a_call(cuda):
    k, w, c = _hist_inputs(1 << 20, 504, 2, cuda)
    before = ksection_hist_cuda.launches
    ksection_hist_cuda(k, w, c)
    ksection_hist_cuda(k, w, c[:100])
    assert ksection_hist_cuda.launches - before == 2


def _all_points(bits, cuda):
    side = 1 << bits
    g = torch.arange(side ** 3, device=cuda, dtype=torch.int32)
    return torch.stack([g // (side * side), (g // side) % side, g % side],
                       dim=1).contiguous()


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("bits", list(range(1, 9)))
def test_sfc_keys_kernel_equal_on_every_point(cuda, curve, bits):
    g = _all_points(bits, cuda)
    plain = ref.hilbert_keys_ref if curve == "hilbert" else ref.morton_keys_ref
    assert torch.equal(sfc_keys_cuda(g, curve=curve, bits=bits).long(),
                       plain(g, bits))


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 1001, 100_003])
def test_sfc_keys_kernel_ragged_tail(cuda, curve, n):
    g = torch.as_tensor(np.random.default_rng(n).integers(0, 1 << 10, (n, 3)),
                        dtype=torch.int32, device=cuda)
    plain = ref.hilbert_keys_ref if curve == "hilbert" else ref.morton_keys_ref
    assert torch.equal(sfc_keys_cuda(g, curve=curve).long(), plain(g))


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("start", [1, 2, 3, 4])
def test_sfc_keys_kernel_misaligned_slice(cuda, curve, start):
    """A contiguous slice of a larger grid starts 12 * start bytes in."""
    full = torch.as_tensor(_grid(100_007, 10, 3), device=cuda).to(torch.int32)
    g = full[start:]
    assert g.is_contiguous()
    plain = ref.hilbert_keys_ref if curve == "hilbert" else ref.morton_keys_ref
    assert torch.equal(ops.sfc_keys_op(g, curve=curve), plain(g))


# --- the kept summation order ---------------------------------------------------

def test_halo_finish_on_a_kept_order_does_not_sync(cuda):
    """With the plan's order built beforehand, halo_finish over a one-part
    exchange makes no host synchronisation; building an order does."""
    from repro_torch.fem.halo import halo_finish
    from repro_torch.segment import SegmentOrder

    class OneRank:
        def all_to_all(self, x):
            return x

    class Done:
        def __init__(self, x):
            self.x = x

        def wait(self):
            return self.x

    rng = np.random.default_rng(4)
    V, H = 50_000, 30_000
    y = torch.as_tensor(rng.standard_normal(V).astype(np.float32),
                        device=cuda)
    recv = torch.as_tensor(rng.integers(0, V + 1, (1, H)), device=cuda)
    send = torch.as_tensor(rng.permutation(V + 1)[None, :H], device=cuda)
    contrib = torch.as_tensor(rng.standard_normal(H).astype(np.float32),
                              device=cuda)
    args = (y, Done(contrib), send, recv, OneRank())
    order = SegmentOrder(recv.reshape(-1), V)
    fresh = halo_finish(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kept = halo_finish(*args, order)
        with pytest.raises(RuntimeError):
            halo_finish(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(kept, fresh)


def test_fem_sums_on_the_mesh_order_equal_fresh_ones_on_card(cuda):
    """build_elements keeps the mesh's order on the card; the FEM sums on
    it give the bits of sums that each build their own."""
    from repro_torch.fem import (HelmholtzProblem, build_elements,
                                 load_vector, mass_matvec, operator_diagonal,
                                 zz_estimate)
    from repro_torch.segment import SegmentOrder
    verts, el_cpu = _random_elements(200_000, 2)
    el = build_elements(verts, el_cpu.tets.numpy(), device=cuda)
    assert el.order is not None
    fresh = el._replace(order=None)
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(
        el.n_verts).astype(np.float32), device=cuda)
    tv = torch.as_tensor(verts, device=cuda)
    prob = HelmholtzProblem()
    for name, fn in (("load_vector", lambda e: load_vector(e, tv, prob.f)),
                     ("operator_diagonal", lambda e: operator_diagonal(e, 1.0)),
                     ("mass_matvec", lambda e: mass_matvec(e, u)),
                     ("zz_estimate", lambda e: zz_estimate(e, u))):
        before = SegmentOrder.builds
        kept = fn(el)
        assert SegmentOrder.builds == before, name
        assert torch.equal(kept, fn(fresh)), name


# --- sharded serving: one rank per group on the card -------------------------
# Four gloo ranks share cuda:0 (collectives staged through host memory);
# the same ranks on the CPU give the reference tokens.

SHARDED_SERVE = dict(slots=8, groups=4, max_seq=128, prefill="packed",
                     prefill_capacity=128, page_size=16, decode="sharded",
                     rebalance="kv", rebalance_every=4)


def _sharded_serve_rank(comm, cfg, weights, spec_kw, n_requests):
    """A smoke-size sharded session over a bursty trace, then a forced
    migration against the same run without it."""
    from repro_torch.kernels import ops
    from repro_torch.models import model_from_tensors
    from repro_torch.serve import (Request, ServeSession, ServeSpec,
                                   bursty_trace, run_trace)
    model = model_from_tensors(cfg, {k: torch.as_tensor(v).to(comm.device)
                                     for k, v in weights.items()})
    trace = bursty_trace(n_requests, seed=3, vocab=cfg.vocab,
                         prompt_buckets=(8, 16, 32), max_new_cap=12)
    sess = ServeSession(model, cfg, ServeSpec(**spec_kw), comm=comm)
    reqs, submit = [], sess.submit
    sess.submit = lambda r: (reqs.append(r), submit(r))[1]
    ops.reset_launch_counts()
    m = run_trace(sess, trace)
    launches = ops.launch_counts()
    forced = []
    for migrate in (False, True):
        s = ServeSession(model, cfg, ServeSpec(**dict(
            spec_kw, prefill="full", rebalance_every=1000)), comm=comm)
        r = Request(rid=0, prompt=trace[0].prompt, max_new=10)
        s.submit(r)
        for i in range(14):
            s.step()
            if migrate and i == 3:
                s.migrate_request(0, dst_group=2)
            if r.done:
                break
        forced.append((list(r.out), r.group, r.migrations))
    return ([r.out for r in reqs], m["migration_log"], launches, forced,
            comm.staged_bytes)


def test_sharded_serving_on_card_matches_cpu_ranks(cuda, tmp_path):
    """Smoke size in float32: the card's ranks give the CPU ranks' tokens
    and migration log, every rank the same; the card ran serve_prefill
    and migrated KV; a forced migration leaves the tokens bit for bit."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import run_world
    from repro_torch.models import init_model
    cfg = get_smoke("llama3_8b").replace(use_pallas=True)
    weights = {k: v.numpy() for k, v in
               init_model(cfg, seed=0, device="cpu").state_dict().items()}
    runs = {}
    for name, devices in (("card", ["cuda:0"] * 4), ("cpu", ["cpu"] * 4)):
        runs[name] = run_world(_sharded_serve_rank, 4, cfg, weights,
                               SHARDED_SERVE, 16,
                               init_file=str(tmp_path / f"rdv-{name}"),
                               devices=devices, timeout_s=120.0, join_s=300.0)
    card, cpu = runs["card"], runs["cpu"]
    for rank in range(4):
        assert card[rank][0] == card[0][0] == cpu[rank][0]
        assert card[rank][1] == card[0][1] == cpu[rank][1]
        assert card[rank][2]["serve_prefill"] > 0
        assert card[rank][4] > 0            # gloo staged through the host
        (ref, _, _), (moved, group, migrations) = card[rank][3]
        assert moved == ref == cpu[rank][3][0][0]
        assert group == 2 and migrations == 1
    assert sum(e["n_moved"] for e in card[0][1]) >= 1


# ---------------------------------------------------------------------------
# training: the attention kernels refuse autograd; a SMOKE train step and
# the packer, card against CPU
# ---------------------------------------------------------------------------

def test_attention_kernels_refuse_grad_on_card(cuda):
    """A kernel launch would drop the gradients of inputs that require
    grad (autograd cannot see it): both wrappers, and the model's flash
    route, raise; without grad they launch."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model, loss_fn
    q = torch.randn(1, 4, 64, 16, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 64, 16, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_op(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.packed_attention_op(q[0], k[0], k[0],
                                torch.zeros(64, dtype=torch.int32,
                                            device=cuda))
    before = flash_attention_cuda.launches
    with torch.no_grad():
        ops.flash_attention_op(q, k, k)
    assert flash_attention_cuda.launches == before + 1
    cfg = get_smoke("llama3_8b").replace(use_pallas=True)
    model = init_model(cfg, device=cuda).requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        loss_fn(model, {"tokens": tokens, "labels": tokens}, cfg)


def _chip_smoke():
    """``chip_smoke.py`` (the repository root's): its phase-22 checks are
    the ones these tests run."""
    import importlib
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("arch,compress", [
    ("llama3_8b", False), ("llama3_8b", True), ("phi35_moe_42b", False),
    ("mamba2_1_3b", False), ("recurrentgemma_2b", False),
    ("whisper_medium", False), ("qwen2_vl_72b", False)])
def test_smoke_train_steps_on_card_match_cpu(cuda, arch, compress):
    """Three SMOKE train steps from the same weights, float32: losses
    within 1e-4 relative, parameters after the first step within 2 lr +
    1e-5 (AdamW's first step moves a weight by about lr times the sign
    of its gradient, which a gradient near 0 may have either way)."""
    _chip_smoke().smoke_train_card_vs_cpu(arch, compress, cuda)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_product_gradients_match_upcast_on_card(cuda, arch):
    """The SMOKE config in bf16: every parameter's gradient of ``loss_fn``
    through ``_ProductF32`` (the card's bf16 products with a float32
    result), leaf by leaf as a share of the leaf's max |g|: within 2^-6
    of the same forward with the backward's products emulated in float32
    (the cotangent rounded to bf16, as ``_ProductF32`` rounds it), and
    within 2^-5 of plain autograd on operands upcast to float32
    (``chip_smoke.PRODUCT_GRAD_TOL`` says why)."""
    _chip_smoke().smoke_product_grads(arch, cuda)


def test_checkpoint_round_trip_and_resume_on_card(cuda, tmp_path):
    _chip_smoke().checkpoint_resume_on_card(cuda, str(tmp_path))


@pytest.mark.parametrize("method", ["sorted", "ksection"])
def test_balanced_pack_on_card_equals_cpu(cuda, method):
    from repro_torch.data import (SyntheticCorpus, balanced_pack,
                                  pack_batches)
    from repro_torch.kernels.ksection_hist import ksection_hist_cuda
    kernel = exclusive_scan_cuda if method == "sorted" else ksection_hist_cuda
    for seed in range(4):
        rng = np.random.default_rng(seed)
        lengths = np.maximum(8, rng.lognormal(5.0, 0.8, 256)).astype(np.int64)
        before = kernel.launches
        rows, info = balanced_pack(lengths, 16, method=method, device=cuda)
        assert kernel.launches > before
        want, winfo = balanced_pack(lengths, 16, method=method, device="cpu")
        assert np.array_equal(rows, want) and info == winfo
        lengths[:10] += 50
        rows2, info2 = balanced_pack(lengths, 16, old_rows=rows,
                                     method=method, device=cuda)
        want2, winfo2 = balanced_pack(lengths, 16, old_rows=want,
                                      method=method, device="cpu")
        assert np.array_equal(rows2, want2) and info2 == winfo2
    docs = SyntheticCorpus(vocab=512, seed=0).documents(200)
    card = list(pack_batches(docs, 8, 512, vocab=512, device=cuda))
    cpu = list(pack_batches(docs, 8, 512, vocab=512, device="cpu"))
    assert len(card) == len(cpu)
    for a, b in zip(card, cpu):
        assert np.array_equal(a["tokens"], b["tokens"])
        assert np.array_equal(a["labels"], b["labels"])
