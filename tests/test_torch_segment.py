"""The fixed-order segment sum (``repro_torch.segment``) against
``jax.ops.segment_sum`` and through the FEM sums that use it, on the CPU.

On the card ``segment_sum`` adds in an order fixed by the ids alone
(``SegmentOrder``); on the CPU it keeps ``index_add_``.  The fixed-order
route is plain PyTorch, so it runs here too: these tests call it directly
and, for the FEM functions, switch ``segment_sum`` onto it.

Tolerances: float32 sums in another order than the reference's
sequential one differ by at most a few roundings of the segment's
sum of |x|, so each segment is held within 1e-5 of its sum of |x|;
integer-valued data is exact in any order and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fem as JF
import repro_torch.fem as TF
from repro_torch import segment
from repro_torch.fem.halo import halo_finish
from repro_torch.segment import (SegmentOrder, segment_sum,
                                 segment_sum_any_order)


def _ids(rng, n, num_segments, dropped):
    """Ids in [0, num_segments) with a ``dropped`` share outside it (-1, -7,
    num_segments and beyond), which both sides drop."""
    ids = rng.integers(0, num_segments, n)
    out = rng.random(n) < dropped
    ids[out] = rng.choice([-1, -7, num_segments, num_segments + 3],
                          int(out.sum()))
    return ids.astype(np.int32)


def _jax_sum(data, ids, num_segments):
    return np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                          num_segments))


# (n, num_segments, row width or None, dropped share)
CASES = [(1000, 37, None, 0.0), (5000, 7, 3, 0.1), (1, 1, None, 0.0),
         (64, 200, None, 0.2), (2000, 1, None, 0.0), (300, 50, 2, 0.3),
         (4 * 3000, 600, None, 0.05)]


@pytest.mark.parametrize("n,num_segments,width,dropped", CASES)
def test_fixed_order_matches_jax_segment_sum(n, num_segments, width,
                                             dropped):
    rng = np.random.default_rng(n + num_segments)
    shape = (n,) if width is None else (n, width)
    data = rng.standard_normal(shape).astype(np.float32)
    ids = _ids(rng, n, num_segments, dropped)
    got = SegmentOrder(torch.as_tensor(ids), num_segments).sum(
        torch.as_tensor(data)).numpy()
    want = _jax_sum(data, ids, num_segments)
    assert got.shape == want.shape
    keep = (ids >= 0) & (ids < num_segments)
    abs_sum = np.zeros(want.shape, np.float64)
    np.add.at(abs_sum, ids[keep], np.abs(data[keep]).astype(np.float64))
    assert np.all(np.abs(got - want) <= 1e-5 * abs_sum)
    assert np.all(got[abs_sum == 0] == 0)       # empty segments exactly 0


@pytest.mark.parametrize("n,num_segments,width,dropped", CASES)
def test_fixed_order_exact_on_integers(n, num_segments, width, dropped):
    rng = np.random.default_rng(n * 3 + num_segments)
    shape = (n,) if width is None else (n, width)
    data = rng.integers(-3, 4, shape).astype(np.float32)
    ids = _ids(rng, n, num_segments, dropped)
    got = SegmentOrder(torch.as_tensor(ids), num_segments).sum(
        torch.as_tensor(data)).numpy()
    np.testing.assert_array_equal(got, _jax_sum(data, ids, num_segments))
    np.testing.assert_array_equal(
        got, segment_sum_any_order(torch.as_tensor(data),
                                   torch.as_tensor(ids), num_segments).numpy())


def test_fixed_order_repeats_its_bits():
    rng = np.random.default_rng(11)
    ids = torch.as_tensor(_ids(rng, 20_000, 900, 0.05))
    a = torch.as_tensor(rng.standard_normal(20_000).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(20_000).astype(np.float32))
    order = SegmentOrder(ids, 900)
    first = order.sum(a)
    assert torch.equal(first, SegmentOrder(ids, 900).sum(a))
    assert torch.equal(first, order.sum(a))
    assert torch.equal(order.sum(b), SegmentOrder(ids.clone(), 900).sum(b))


def test_fixed_order_empty_inputs():
    z = torch.zeros(0)
    assert SegmentOrder(torch.zeros(0, dtype=torch.int64), 5).sum(z).tolist() \
        == [0.0] * 5
    assert SegmentOrder(torch.arange(4), 0).sum(torch.ones(4)).shape == (0,)
    x = torch.ones((3, 2))
    out = SegmentOrder(torch.tensor([9, -1, 4]), 4).sum(x)
    assert out.shape == (4, 2) and float(out.abs().sum()) == 0.0


def test_segment_sum_routes_by_device(monkeypatch):
    """CPU tensors take ``index_add_`` (the reference's input order); the
    fixed-order route is taken where ``_in_fixed_order`` says so."""
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(_ids(rng, 3000, 40, 0.1))
    x = torch.as_tensor(rng.standard_normal(3000).astype(np.float32))
    assert torch.equal(segment_sum(x, ids, 40),
                       segment_sum_any_order(x, ids, 40))
    monkeypatch.setattr(segment, "_in_fixed_order", lambda t: True)
    assert torch.equal(segment_sum(x, ids, 40), SegmentOrder(ids, 40).sum(x))


# --- the FEM sums through the fixed-order route ----------------------------
# The tolerances of test_torch_fem.py: rtol 1e-5 for assembly, 1e-4 for
# the estimator.

def _elements():
    jm = JF.cylinder_mesh(8, 2, length=4.0, radius=0.5)
    rng = np.random.default_rng(2)
    for _ in range(2):
        JF.refine(jm, rng.random(jm.n_tets) < 0.3)
    return (jm, JF.build_elements(jm.verts, jm.tets),
            TF.build_elements(jm.verts, jm.tets, device="cpu"))


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(initial=0.0),
                                               1e-30))


@pytest.fixture
def fixed_order(monkeypatch):
    monkeypatch.setattr(segment, "_in_fixed_order", lambda t: True)


def _fem_pairs(jm, jel, tel):
    rng = np.random.default_rng(0)
    u = rng.standard_normal(jm.n_verts).astype(np.float32)
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    verts32 = jm.verts.astype(np.float32)
    jp, tp = JF.HelmholtzProblem(), TF.HelmholtzProblem()
    return {
        "load_vector": (lambda: TF.load_vector(tel, torch.as_tensor(verts32),
                                               tp.f),
                        lambda: JF.load_vector(jel, jnp.asarray(verts32),
                                               jp.f), 1e-5),
        "operator_diagonal": (lambda: TF.operator_diagonal(tel, 25.0),
                              lambda: JF.operator_diagonal(jel, 25.0), 1e-5),
        "mass_matvec": (lambda: TF.mass_matvec(tel, tu),
                        lambda: JF.mass_matvec(jel, ju), 1e-5),
        "stiffness_matvec": (lambda: TF.stiffness_matvec(tel, tu, 1.0),
                             lambda: JF.stiffness_matvec(jel, ju, 1.0), 1e-5),
        "zz_estimate": (lambda: TF.zz_estimate(tel, tu),
                        lambda: JF.zz_estimate(jel, ju), 1e-4),
    }


@pytest.mark.parametrize("name", ["load_vector", "operator_diagonal",
                                  "mass_matvec", "stiffness_matvec",
                                  "zz_estimate"])
def test_fem_sums_in_fixed_order_match_reference(fixed_order, name):
    got_fn, want_fn, rtol = _fem_pairs(*_elements())[name]
    got = got_fn()
    _close(got, want_fn(), rtol)
    assert torch.equal(got, got_fn())       # the same bits on a second call


class _OneRank:
    """A one-part world: every all_to_all returns what it is given."""

    def all_to_all(self, x):
        return x


class _Done:
    def __init__(self, x):
        self.x = x

    def wait(self):
        return self.x


@pytest.mark.parametrize("route", ["cpu", "fixed"])
def test_halo_finish_sums_leg_one(monkeypatch, route):
    """halo_finish adds leg 1's contributions into their owned slots
    (padding slot V dropped) and restores every ghost slot from its
    owner, on either route; the fixed route repeats its bits."""
    if route == "fixed":
        monkeypatch.setattr(segment, "_in_fixed_order", lambda t: True)
    rng = np.random.default_rng(4)
    V, H = 50, 40
    y = rng.standard_normal(V).astype(np.float32)
    recv = rng.integers(0, V + 1, (1, H))            # V = padding
    send = rng.permutation(V + 1)[None, :H]          # one slot each
    contrib = rng.standard_normal(H).astype(np.float32)
    contrib[recv[0] == V] = 0.0                      # the wire's zeros
    args = (torch.as_tensor(y), _Done(torch.as_tensor(contrib)),
            torch.as_tensor(send), torch.as_tensor(recv), _OneRank())
    got = halo_finish(*args).numpy()
    want = y.astype(np.float64)
    keep = recv[0] < V
    np.add.at(want, recv[0][keep], contrib[keep])
    back = np.where(keep, want[np.minimum(recv[0], V - 1)], 0.0)
    s = send[0] < V
    want[send[0][s]] = back[s]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, halo_finish(*args).numpy())
