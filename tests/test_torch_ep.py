"""The expert-parallel MoE layer on a model axis of 4 gloo CPU ranks,
against the JAX package's unsharded ``moe_apply`` and ``jax.grad``.

The cases are the reference's own red ``test_moe_ep_shardmap_parity``
(``n_experts`` 4 and 2 with ``ep_shards=4``, so 1 and 2 ranks an expert,
f-slices for 2; x of (4, 16, 32); its rules, experts on "model"),
whose mesh-sharded run fails under JAX 0.9.0 (Explicit axes), and the
launcher's ``ep_shards=0`` branch, each rank holding a block of the
experts: 4 experts (one a rank) and 8 at ``capacity_factor=1.0``, where
items are dropped -- so a capacity taken from the rank's E/m experts
rather than from E would change the output.  Weights are the JAX
package's ``init_moe``; each rank holds its slice of the stored expert
rows and the whole (replicated) router.

Limits: the output within the reference test's 1e-4 and the gradients
of ``sum(out^2)`` within its 1e-3 (absolute), and both within 1e-5 of
their max |value| (the port's).  The gradients of the aux loss, which
every rank computes alike from the replicated router, equal the
reference's within 1e-5 of max |g| too (AUX_ATOL where they are 0 in
exact arithmetic): summed over the ranks they would be 4 times too
large.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import ModelConfig as JModelConfig
from repro.models.moe import init_moe as j_init_moe
from repro.models.moe import moe_apply as j_moe_apply

import _torch_world as W

REF_OUT_TOL, REF_GRAD_TOL = 1e-4, 1e-3     # the reference test's limits
RTOL = 1e-5
#: an aux gradient's error allowed where both sides are rounding noise:
#: with 2 experts and top 2 every token goes to both (f_e = 1/2), and the
#: aux's gradient is 0 in exact arithmetic (~1e-8 on both sides)
AUX_ATOL = 1e-7

BASE = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=4,
            n_kv_heads=4, d_ff=64, vocab=64, top_k=2, dtype="float32",
            param_dtype="float32")
REF_RULES = {"batch": ("data",), "expert": "model", "seq": None,
             "embed": None, "mlp": None, "vocab": None}
CASES = {
    "ep4-e4": dict(BASE, n_experts=4, capacity_factor=4.0, ep_shards=4),
    "ep4-e2": dict(BASE, n_experts=2, capacity_factor=2.0, ep_shards=4),
    "ep0-e4": dict(BASE, n_experts=4, capacity_factor=4.0),
    "ep0-e8-drops": dict(BASE, n_experts=8, capacity_factor=1.0),
}


def _reference(kw, x):
    """(params as numpy by name, out, aux, grads of sum(out^2), grads of
    aux) of the JAX package's unsharded layer."""
    cfg = JModelConfig(**kw)
    params = j_init_moe(jax.random.PRNGKey(0), cfg)
    xj = jnp.asarray(x)
    out, aux = j_moe_apply(params, xj, cfg)
    g_out = jax.grad(lambda p: jnp.sum(j_moe_apply(p, xj, cfg)[0] ** 2))(
        params)
    g_aux = jax.grad(lambda p: j_moe_apply(p, xj, cfg)[1])(params)

    def leaves(tree):
        return {n: np.asarray(getattr(b, "value", b)) for n, b in tree.items()}
    return (leaves(params), np.asarray(out), float(aux), leaves(g_out),
            leaves(g_aux))


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    x = np.random.default_rng(0).standard_normal((4, 16, 32)).astype(
        np.float32)
    want = {key: _reference(kw, x) for key, kw in CASES.items()}
    cases = {key: (kw, REF_RULES, x, want[key][0])
             for key, kw in CASES.items()}
    ranks = W.world(W.ep_world, cases,
                    tmp_path=tmp_path_factory.mktemp("ep"), p=4)
    return {"ranks": ranks, "want": want}


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.mark.parametrize("key", list(CASES))
def test_output_matches_the_unsharded_layer(ep, key):
    _, out, aux, _, _ = ep["want"][key]
    for res in ep["ranks"]:
        got = res[key]
        assert float(np.max(np.abs(got["out"] - out))) < REF_OUT_TOL
        assert _rel(got["out"], out) <= RTOL
        assert abs(got["aux"] - aux) <= RTOL * abs(aux)


@pytest.mark.parametrize("key", list(CASES))
def test_gradients_match_the_unsharded_layer(ep, key):
    _, _, _, g_out, g_aux = ep["want"][key]
    got = ep["ranks"][0][key]
    for n, w in g_out.items():
        assert float(np.max(np.abs(got["grad_out"][n] - w))) < REF_GRAD_TOL
        assert _rel(got["grad_out"][n], w) <= RTOL, n
    for n, w in g_aux.items():
        err = float(np.max(np.abs(got["grad_aux"][n] - w)))
        assert err <= max(RTOL * float(np.max(np.abs(w))), AUX_ATOL), n


@pytest.mark.parametrize("key", list(CASES))
def test_each_rank_holds_its_expert_rows(ep, key):
    """A quarter of the stored expert rows a rank (one row: an expert,
    or an expert's f-slice, for ``ep_shards=4``), and every rank the
    same whole gradients."""
    kw = CASES[key]
    rows = kw.get("ep_shards") or kw["n_experts"]
    first = ep["ranks"][0][key]
    for res in ep["ranks"]:
        assert res[key]["local_rows"][0] * 4 == rows
        for n, g in res[key]["grad_out"].items():
            np.testing.assert_array_equal(g, first["grad_out"][n], n)
