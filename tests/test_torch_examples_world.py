"""The port's two multi-rank examples (``examples/torch/parallel_fem.py``
and ``serve_continuous.py``) in one gloo world of 4 CPU ranks, their rank
functions run as the scripts run them.

parallel_fem asserts in every rank that its owned-layout PCG matches the
session's solution and the replicated-layout oracle within 1e-4.  The
serving example's rebalance decisions follow the requests' KV lengths
only, not the weights, so its migration log and token counts are held
against the JAX package's same sharded session on 4 of the suite's 8
host devices (run here while the ranks run).
"""
import concurrent.futures

import jax
import pytest

import _torch_world as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        outs = pool.submit(W.world, W.examples_world,
                           tmp_path=tmp_path_factory.mktemp("examples"))
        yield outs.result(), _reference_serve()


def _reference_serve():
    """The JAX package's calls of examples/serve_continuous.py."""
    from repro.configs import get_smoke
    from repro.core import BalanceSpec
    from repro.models import init_model
    from repro.serve import ServeSession, ServeSpec, bursty_trace, run_trace
    cfg = get_smoke("llama3_8b").replace(n_layers=4, d_model=256, n_heads=8,
                                         n_kv_heads=4, head_dim=32, d_ff=512)
    params = init_model(cfg, jax.random.PRNGKey(0))
    groups = 4
    spec = ServeSpec(
        slots=8, groups=groups, max_seq=128, rebalance_every=8,
        prefill="full", decode="sharded", rebalance="kv",
        balance=BalanceSpec(p=groups, method="linear", oneD="ksection",
                            warm_start=True))
    trace = bursty_trace(24, seed=0, vocab=cfg.vocab,
                         prompt_buckets=(4, 8, 16, 24), max_new_cap=48)
    return run_trace(ServeSession(params, cfg, spec), trace, max_steps=600)


def test_parallel_fem_example_on_4_ranks(ranks):
    outs, _ = ranks
    fem = [o["parallel_fem"] for o in outs]
    assert all(f["lines"] == fem[0]["lines"] for f in fem)
    assert all(f["stats"] == fem[0]["stats"] for f in fem)
    assert len(fem[0]["stats"]) == 4
    assert max(f["gap_session"] for f in fem) < 1e-4
    assert max(f["gap_rep"] for f in fem) < 1e-4
    assert fem[0]["lines"][-1].startswith("owned-vertex PCG on final mesh")
    # the owned layout's halo bytes undercut the replicated psum
    assert all(halo < psum for *_, halo, psum in fem[0]["stats"])


def test_serve_continuous_example_matches_reference_log(ranks):
    outs, want = ranks
    serve = [o["serve_continuous"] for o in outs]
    got = serve[0]
    assert all(s["outputs"] == got["outputs"] for s in serve)
    assert (got["completed"], got["requests"], got["tokens"],
            got["steps"]) == (want["completed"], want["requests"],
                              want["tokens"], want["steps"])
    assert got["completed"] == 24
    assert all(s["migration_log"] == want["migration_log"] for s in serve)
    assert sum(e["moved_kv_bytes"] > 0 for e in got["migration_log"]) == 4
