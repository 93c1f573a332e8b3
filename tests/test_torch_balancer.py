"""The port's ``Balancer`` against the JAX package's on shared numpy
inputs (the quickstart's standalone step: 10k points), on the CPU.

Integer weights keep every float32 sum exact, so every ``BalanceResult``
field must be identical; float weights are summed in another order, so
they are held to a tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * np.array([10.0, 1.0, 1.0])).astype(np.float32)


# --- Balancer ------------------------------------------------------------------

BALANCE_FIELDS = ("parts", "part_weights", "imbalance", "total_v", "max_v",
                  "retained", "remap_perm", "splitters")


def assert_same_result(got, want):
    for f in BALANCE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f)
    assert (got.ksection_rounds is None) == (want.ksection_rounds is None)
    if got.ksection_rounds is not None:
        assert got.ksection_rounds == int(want.ksection_rounds)


def _balance_inputs(n, p, seed):
    rng = np.random.default_rng(seed)
    return (_points(n, seed), rng.integers(1, 5, n).astype(np.float32),
            rng.integers(0, p, n).astype(np.int32))


SOLVER_CASES = ([(m, o) for m in ("hsfc", "msfc", "hsfc_zoltan", "linear")
                 for o in ("sorted", "ksection")] + [("rtk", "sorted"),
                                                     ("rcb", "sorted")])


def _run_both(spec, coords, w, old_parts):
    jb = J.Balancer(J.BalanceSpec.from_dict(spec.to_dict()))
    tb = T.Balancer(spec, device="cpu")
    want = jb.balance(jnp.asarray(w), coords=jnp.asarray(coords),
                      old_parts=None if old_parts is None
                      else jnp.asarray(old_parts))
    return tb.balance(w, coords=coords, old_parts=old_parts), want


@pytest.mark.parametrize("method,oneD", SOLVER_CASES)
@pytest.mark.parametrize("with_old", [False, True])
def test_balancer_identical_p16(method, oneD, with_old):
    coords, w, old = _balance_inputs(10_000, 16, 0)
    spec = T.BalanceSpec(p=16, method=method, oneD=oneD)
    assert_same_result(*_run_both(spec, coords, w, old if with_old else None))


@pytest.mark.parametrize("method,oneD", [("hsfc", "sorted"),
                                         ("hsfc", "ksection"),
                                         ("msfc", "ksection"),
                                         ("rtk", "sorted"), ("rcb", "sorted")])
def test_balancer_identical_p128(method, oneD):
    coords, w, old = _balance_inputs(10_000, 128, 1)
    spec = T.BalanceSpec(p=128, method=method, oneD=oneD)
    assert_same_result(*_run_both(spec, coords, w, old))


@pytest.mark.parametrize("oneD", ["sorted", "ksection"])
def test_balancer_float_weights_within_tolerance(oneD):
    """Float weights: cumsum order differs between the packages, so parts
    may move at the margins (imbalance within 1e-5, <= 0.1 % of items)."""
    rng = np.random.default_rng(2)
    coords = _points(10_000, 2)
    w = (rng.random(10_000) + 0.1).astype(np.float32)
    got, want = _run_both(T.BalanceSpec(p=128, method="hsfc", oneD=oneD),
                          coords, w, None)
    assert abs(float(got.imbalance) - float(want.imbalance)) <= 1e-5
    differ = np.mean(_np(got.parts) != np.asarray(want.parts))
    assert differ <= 1e-3


def test_balancer_pads_and_threads_warm_splitters():
    coords, w, _ = _balance_inputs(3_000, 16, 3)
    spec = T.BalanceSpec(p=16, oneD="ksection", warm_start=True)
    tb = T.Balancer(spec, device="cpu")
    jb = J.Balancer(J.BalanceSpec.from_dict(spec.to_dict()))
    for scale in (1.0, 1.5):
        ww = (w * scale).round()
        got = tb.balance(ww, coords=coords)
        want = jb.balance(jnp.asarray(ww), coords=jnp.asarray(coords))
        assert_same_result(got, want)
        assert got.parts.shape == (3_000,)


def test_spec_dicts_round_trip_across_packages():
    from repro.fem import AdaptSpec as JAdapt
    from repro_torch.fem import AdaptSpec as TAdapt
    jspec = J.BalanceSpec(p=64, method="msfc", oneD="ksection", use_pallas=False,
                          warm_start=True, ksection_tol=0.5)
    tspec = T.BalanceSpec.from_dict(jspec.to_dict())
    assert tspec.to_dict() == jspec.to_dict()
    assert J.BalanceSpec.from_dict(tspec.to_dict()) == jspec
    ja = JAdapt.for_problem("helmholtz", max_steps=3, incremental=True,
                            balance=jspec)
    ta = TAdapt.from_dict(ja.to_dict())
    assert ta.to_dict() == ja.to_dict()
    assert JAdapt.from_dict(ta.to_dict()) == ja
    with pytest.raises(ValueError):
        T.BalanceSpec.from_dict({"p": 4, "bogus": 1})
    with pytest.raises(ValueError):
        T.BalanceSpec(p=4, method="nope")


def test_sharded_backend_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.Balancer(T.BalanceSpec(p=4, backend="sharded"), device="cpu")
