"""The port's warn-once deprecation helper and the per-module wrapper
hooks, mirroring the JAX package's ``tests/test_deprecation.py`` case
for case; the port's four shim modules share one registry, as the JAX
package's do."""
import warnings

import pytest

from repro import deprecation as jdeprecation
from repro_torch import deprecation


@pytest.fixture(autouse=True)
def _clean_registry():
    deprecation.reset()
    yield
    deprecation.reset()


def _messages(mod, calls):
    """The warnings ``calls(mod)`` emits, as strings."""
    mod.reset()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        calls(mod)
    assert all(w.category is DeprecationWarning for w in rec)
    return [str(w.message) for w in rec]


def _once_per_key(mod):
    mod.warn_once("k1", "k1 is deprecated", stacklevel=1)
    mod.warn_once("k1", "k1 is deprecated", stacklevel=1)
    mod.warn_once("k2", "k2 is deprecated", stacklevel=1)


def _selective_and_global(mod):
    mod.warn_once("a", "a!", stacklevel=1)
    mod.warn_once("b", "b!", stacklevel=1)
    mod.reset("a")
    mod.warn_once("a", "a!", stacklevel=1)   # fires again
    mod.warn_once("b", "b!", stacklevel=1)   # still silenced
    mod.reset()
    mod.warn_once("b", "b!", stacklevel=1)   # fires again


@pytest.mark.parametrize("calls,want", [
    (_once_per_key, ["k1 is deprecated", "k2 is deprecated"]),
    (_selective_and_global, ["a!", "b!", "a!", "b!"])],
    ids=["warn_once_fires_once_per_key", "reset_selective_and_global"])
def test_warn_once_and_reset_match_the_reference(calls, want):
    assert _messages(deprecation, calls) == want
    assert _messages(jdeprecation, calls) == want


def test_module_wrappers_share_the_registry():
    """The shims route through one registry, but each under its own key
    -- silencing one legacy API never silences another; the distributed
    balancer shares the eager balancer's key, as in the JAX package."""
    from repro_torch.core import balancer as core_balancer
    from repro_torch.distributed import balancer as dist_balancer
    from repro_torch.fem import adapt as fem_adapt
    from repro_torch.serve import engine as serve_engine

    for mod in (core_balancer, fem_adapt, serve_engine):
        mod._reset_deprecation_warning()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        core_balancer._warn_deprecated_once()
        dist_balancer._warn_deprecated_once()
        fem_adapt._warn_deprecated_once("solve_helmholtz_adaptive")
        fem_adapt._warn_deprecated_once("solve_parabolic_adaptive")
        serve_engine._warn_deprecated_once()
    msgs = [str(w.message) for w in rec]
    assert len(msgs) == 3
    assert "BalanceSpec" in msgs[0]
    assert "AdaptSpec" in msgs[1]
    assert "ServeSpec" in msgs[2]
    # the per-module reset hooks still work (the test-suite contract)
    fem_adapt._reset_deprecation_warning()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fem_adapt._warn_deprecated_once("solve_helmholtz_adaptive")
        core_balancer._warn_deprecated_once()   # still silenced
    assert len(rec) == 1 and "AdaptSpec" in str(rec[0].message)
