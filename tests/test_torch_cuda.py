"""The hand-written CUDA kernels on the card, against their plain versions.

Imports no JAX, so it runs on the machine with the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test carries the ``cuda`` marker, needs a CUDA device and skips
without one (the kernels have no CPU mode).  The plain versions are held against the JAX package in
test_torch_kernels.py, on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Balancer, BalanceSpec
from repro_torch.fem import AdaptiveSession, AdaptSpec, cylinder_mesh
from repro_torch.kernels import ops
from repro_torch.kernels.fem_matvec import (fem_element_matrices,
                                            fem_matvec_cuda)
from repro_torch.kernels.ksection_hist import ksection_hist_cuda
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


def test_session_on_card_launches_all_kernels_and_tracks_cpu(cuda):
    spec = AdaptSpec.for_problem(
        "helmholtz", max_steps=3, max_tets=6000, tol=1e-6, incremental=True,
        trigger="always", balance=BalanceSpec(p=16, oneD="ksection"))
    ops.reset_launch_counts()
    a = AdaptiveSession(spec, device=cuda).run(
        cylinder_mesh(8, 2, length=4.0, radius=0.5))
    assert all(n > 0 for n in ops.launch_counts().values())
    b = AdaptiveSession(spec, device="cpu").run(
        cylinder_mesh(8, 2, length=4.0, radius=0.5))
    assert a.n_repartitions == b.n_repartitions
    for x, y in zip(a.stats, b.stats):
        assert abs(x.n_tets - y.n_tets) <= 0.01 * y.n_tets
        assert abs(x.err_l2 - y.err_l2) <= 0.02 * y.err_l2
