"""The deprecated shims of the port against the JAX package's, on the CPU:
``DynamicLoadBalancer`` (every method x both 1-D solvers),
``DistributedBalancer`` and the sharded ``DynamicLoadBalancer`` over a
gloo world of 4 CPU ranks against the JAX package's on 4 of the suite's
8 host devices, and ``ServeEngine`` at SMOKE llama width, on one device
and with its balancer sharded over the world.

Integer weights keep every float32 sum exact, so parts, TotalV and cut
must be identical; float weights may move parts at the margins (ROADMAP
queue 3, item 3): imbalance within 1e-5 and at most 0.1 % of the parts.
Each shim warns exactly once per process in both packages.
"""
import concurrent.futures
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import configs as jconfigs
from repro import deprecation as jdeprecation
from repro.models import init_model as j_init_model
from repro.serve import ServeEngine as JServeEngine
from repro.serve import bursty_trace as j_bursty_trace
from repro.serve import run_trace as j_run_trace
from repro_torch import configs, deprecation
from repro_torch.interop import params_from_jax
from repro_torch.serve import ServeEngine, bursty_trace, run_trace

import _torch_world as W

METHODS = ("rtk", "hsfc", "msfc", "hsfc_zoltan", "rcb")
N, P = 5000, 8


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _inputs(float_weights=False, n=N, p=P, seed=0):
    rng = np.random.default_rng(seed)
    coords = (rng.random((n, 3)) * np.array([10.0, 1.0, 1.0])
              ).astype(np.float32)
    w = ((rng.random(n) + 0.1) if float_weights
         else rng.integers(1, 4, n)).astype(np.float32)
    old = rng.integers(0, p, n)
    adj = rng.integers(0, n, (3 * n, 2))
    return coords, w, old, adj


def _both(method, oneD, coords, w, old, adj, p=P):
    t = T.DynamicLoadBalancer(p, method, oneD=oneD, device="cpu").balance(
        torch.as_tensor(w), coords=torch.as_tensor(coords),
        old_parts=torch.as_tensor(old), adjacency=adj)
    j = J.DynamicLoadBalancer(p, method, oneD=oneD).balance(
        jnp.asarray(w), coords=jnp.asarray(coords),
        old_parts=jnp.asarray(old), adjacency=jnp.asarray(adj))
    return t, j


def _same_info(tinfo, jinfo):
    """The same keys, the same Python types, and equal values except
    the wall-clock time."""
    assert sorted(tinfo) == sorted(jinfo)
    for k, jv in jinfo.items():
        tv = tinfo[k]
        if k in ("t_partition", "t_remap"):
            assert isinstance(tv, float)
        elif k == "remap_perm":
            np.testing.assert_array_equal(tv.cpu().numpy(), np.asarray(jv))
        elif k == "part_weights":
            assert isinstance(tv, np.ndarray)
            np.testing.assert_array_equal(tv, np.asarray(jv))
        else:
            assert type(tv) is type(jv), k
            assert tv == jv, k


@pytest.mark.parametrize("oneD", ["sorted", "ksection"])
@pytest.mark.parametrize("method", METHODS)
def test_dynamic_load_balancer_integer_weights_bit_for_bit(method, oneD):
    coords, w, old, adj = _inputs()
    t, j = _both(method, oneD, coords, w, old, adj)
    np.testing.assert_array_equal(t.parts.numpy(), np.asarray(j.parts))
    _same_info(t.info, j.info)
    assert t.info["cut"] > 0 and t.info["TotalV"] > 0


@pytest.mark.parametrize("method,oneD", [("hsfc", "sorted"),
                                         ("hsfc", "ksection"),
                                         ("rtk", "sorted")])
def test_dynamic_load_balancer_float_weights_within_tolerance(method, oneD):
    coords, w, old, adj = _inputs(float_weights=True, n=10_000)
    t, j = _both(method, oneD, coords, w, old, adj)
    differ = int((t.parts.numpy() != np.asarray(j.parts)).sum())
    assert differ <= 0.001 * len(w)
    assert abs(t.info["imbalance"] - j.info["imbalance"]) <= 1e-5


def test_balance_result_alias_and_lazy_refusal():
    """``BalanceResult`` is the legacy result's old name; a spec with no
    registered stage for its backend constructs and raises at
    ``balance()`` time in both packages (the port's sharded backend
    needs its process group)."""
    from repro_torch.core import balancer as tb
    from repro.core import balancer as jb
    assert tb.BalanceResult is tb.LegacyBalanceResult
    assert jb.BalanceResult is jb.LegacyBalanceResult
    coords, w, _, _ = _inputs(n=64)
    t = T.DynamicLoadBalancer(4, "rtk", backend="sharded", device="cpu")
    j = J.DynamicLoadBalancer(4, "rtk", backend="sharded")
    with pytest.raises(ValueError):
        t.balance(torch.as_tensor(w), coords=torch.as_tensor(coords))
    with pytest.raises(ValueError):
        j.balance(jnp.asarray(w), coords=jnp.asarray(coords))
    assert (t.p, t.method, t.oneD, t.k, t.iters, t.use_remap, t.sfc_bits,
            t.backend) == (j.p, j.method, j.oneD, j.k, j.iters,
                           j.use_remap, j.sfc_bits, j.backend)
    assert t.spec.to_dict() == j.spec.to_dict()


# --- the deprecation warnings ------------------------------------------------

def _tiny_models():
    jcfg = jconfigs.get_smoke("llama3_8b")
    cfg = configs.get_smoke("llama3_8b")
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


@pytest.fixture(scope="module")
def smoke_llama():
    return _tiny_models()


def _shim_calls(name, smoke_llama):
    """(port call, reference call) constructing shim ``name`` once; the
    FEM drivers and ``DistributedBalancer`` are given arguments that
    raise right after the warning, so no session or group is needed."""
    if name == "DynamicLoadBalancer":
        return (lambda: T.DynamicLoadBalancer(4, device="cpu"),
                lambda: J.DynamicLoadBalancer(4))
    if name == "DistributedBalancer":
        from repro.distributed import DistributedBalancer as JD
        from repro_torch.distributed import DistributedBalancer as TD
        return lambda: TD(4, "rtk"), lambda: JD(4, "rtk")
    if name.startswith("solve_"):
        import repro.fem as JF
        import repro_torch.fem as TF
        return (lambda: getattr(TF, name)(TF.unit_cube_mesh(1), theta=0.0,
                                          device="cpu"),
                lambda: getattr(JF, name)(JF.unit_cube_mesh(1), theta=0.0))
    jcfg, cfg, params, model = smoke_llama
    return (lambda: ServeEngine(model, cfg, device="cpu"),
            lambda: JServeEngine(params, jcfg))


SHIM_KEY = {"DistributedBalancer": "DynamicLoadBalancer"}


@pytest.mark.parametrize("name", ["DynamicLoadBalancer",
                                  "DistributedBalancer",
                                  "solve_helmholtz_adaptive",
                                  "solve_parabolic_adaptive", "ServeEngine"])
def test_each_shim_warns_exactly_once(name, smoke_llama):
    for reg, call in zip((deprecation, jdeprecation),
                         _shim_calls(name, smoke_llama)):
        reg.reset()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(2):
                try:
                    call()
                except ValueError:
                    pass
        dep = [w for w in rec if w.category is DeprecationWarning]
        assert len(dep) == 1, (reg.__name__, [str(w.message) for w in dep])
        # the distributed shim warns under the eager balancer's key
        assert SHIM_KEY.get(name, name) in str(dep[0].message)
        reg.reset()


# --- ServeEngine on one device -----------------------------------------------

TRACE = dict(seed=0, prompt_buckets=(4, 8, 16), max_new_cap=12)
ENGINE = dict(slots=8, max_seq=64, n_groups=4, rebalance_every=4)


def _run(engine, trace, run):
    reqs, submit = [], engine.submit
    engine.submit = lambda r: (reqs.append(r), submit(r))[1]
    m = run(engine, trace)
    return [r.out for r in reqs], m["migration_log"]


def test_serve_engine_matches_reference(smoke_llama):
    jcfg, cfg, params, model = smoke_llama
    eng = ServeEngine(model, cfg, device="cpu", **ENGINE)
    jeng = JServeEngine(params, jcfg, **ENGINE)
    assert eng.spec.to_dict() == jeng.spec.to_dict()
    assert (eng.spec.prefill, eng.spec.decode, eng.spec.rebalance) == (
        "cheap", "replicated", "tags")
    t_out, t_log = _run(eng, bursty_trace(24, vocab=cfg.vocab, **TRACE),
                        run_trace)
    j_out, j_log = _run(jeng, j_bursty_trace(24, vocab=cfg.vocab, **TRACE),
                        j_run_trace)
    assert t_out == j_out
    assert t_log == j_log and len(t_log) >= 5


# --- the multi-device shims over a 4-rank world ------------------------------

P4 = 4
WORLD_CASES = [("distributed", "hsfc", "sorted", False),
               ("distributed", "hsfc", "sorted", True),
               ("distributed", "msfc", "ksection", True),
               ("distributed", "hsfc_zoltan", "ksection", False),
               ("dynamic", "hsfc", "ksection", True),
               ("dynamic", "msfc", "sorted", True)]


@pytest.fixture(scope="module", autouse=True)
def _world_started(tmp_path_factory, smoke_llama):
    """The port's world, started with the module (in a thread: the ranks
    are processes) while the JAX package runs the cases before it."""
    _, cfg, _, model = smoke_llama
    coords, w, old, _ = _inputs(n=3000, p=P4, seed=1)
    weights = {n: p.detach().numpy() for n, p in model.named_parameters()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield (coords, w, old), pool.submit(
            W.world, W.legacy_world, coords, w, old, WORLD_CASES,
            (cfg, weights, TRACE),
            tmp_path=tmp_path_factory.mktemp("legacy"))


@pytest.fixture(scope="module")
def world(_world_started):
    inputs, outs = _world_started
    return inputs, outs.result()


def _reference_case(case, coords, w, old):
    from repro.distributed import DistributedBalancer as JD
    shim, method, oneD, use_old = case
    b = (JD(P4, method, oneD=oneD) if shim == "distributed" else
         J.DynamicLoadBalancer(P4, method, oneD=oneD, backend="sharded"))
    r = b.balance(jnp.asarray(w), coords=jnp.asarray(coords),
                  old_parts=jnp.asarray(old) if use_old else None)
    return W.legacy_info_of(r)


@pytest.mark.parametrize("i", range(len(WORLD_CASES)),
                         ids=["-".join(map(str, c)) for c in WORLD_CASES])
def test_sharded_shims_match_reference_on_every_rank(world, i):
    (coords, w, old), outs = world
    want_parts, want = _reference_case(WORLD_CASES[i], coords, w, old)
    for r, o in enumerate(outs):
        parts, got = o["cases"][i]
        np.testing.assert_array_equal(parts, want_parts, err_msg=f"rank {r}")
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v and type(got[k]) is type(v), k
    assert "capacity" in want and want["backend"] == "sharded"


def test_distributed_balancer_refusals_match_reference(world):
    from repro.distributed import DistributedBalancer as JD
    (coords, w, _), outs = world
    want = []
    for make in (lambda: JD(P4, "rtk"),
                 lambda: JD(P4).balance(jnp.asarray(w))):
        with pytest.raises(ValueError) as e:
            make()
        want.append(str(e.value))
    assert all(o["errors"] == want for o in outs)


def test_serve_engine_with_sharded_balancer_matches_reference(world,
                                                              smoke_llama):
    jcfg, cfg, params, _ = smoke_llama
    _, outs = world
    jeng = JServeEngine(params, jcfg, backend="sharded", **ENGINE)
    want = _run(jeng, j_bursty_trace(24, vocab=cfg.vocab, **TRACE),
                j_run_trace)
    assert len(want[1]) >= 5
    for o in outs:
        assert o["serve"][0] == want[0]
        assert o["serve"][1] == want[1]
