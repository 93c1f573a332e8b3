"""The port's examples (``examples/torch/``) on the CPU at their smoke
sizes, held against the JAX package's same calls where the numbers are
deterministic: quickstart's mesh sizes, imbalance and repartitions for
one method and its standalone DLB step's imbalance; moe_balance's
imbalances and drop rates; train_lm runs, checkpoints and resumes.  The
two multi-rank examples run in ``test_torch_examples_world.py``.

Also pinned: the k-section with one part and warm-start splitters (what
serve_continuous runs on a world of one rank) raises in both packages.
"""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

import _torch_world as W


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = main(argv)
    return res, out.getvalue()


def test_quickstart_matches_reference_calls(monkeypatch):
    """The smoke configuration: rtk and hsfc, 2 adaptive steps; hsfc is
    held against the JAX session, the standalone DLB against the JAX
    balancer (float weights: imbalance within 1e-5, ROADMAP queue 3,
    item 3)."""
    import repro.fem as JF
    monkeypatch.setenv("QUICKSTART_SMOKE", "1")
    got, text = _quiet(W.load_example("quickstart").main, ["--device", "cpu"])
    assert sorted(got["methods"]) == ["hsfc", "rtk"]
    assert "hsfc on 10k pts -> 128 parts" in text
    spec = JF.AdaptSpec.for_problem(
        "helmholtz", max_steps=2, max_tets=6000, tol=1e-6,
        balance=J.BalanceSpec(p=16, method="hsfc"))
    res = JF.AdaptiveSession(spec).run(
        JF.cylinder_mesh(8, 2, length=4.0, radius=0.5))
    last = res.stats[-1]
    mine = got["methods"]["hsfc"]
    assert (mine["tets"], mine["repartitions"]) == (last.n_tets,
                                                    res.n_repartitions)
    assert mine["imbalance"] == last.imbalance
    assert abs(mine["err"] - last.err_l2) <= 1e-4 * last.err_l2
    rng = np.random.default_rng(0)
    n = 10_000
    coords = jnp.asarray(rng.random((n, 3)) * np.array([10.0, 1.0, 1.0]))
    w = jnp.asarray((rng.random(n) + 0.1).astype(np.float32))
    spec = J.BalanceSpec(p=128, method="hsfc", oneD="sorted")
    for oneD in ("sorted", "ksection"):
        r = J.Balancer.from_spec(spec.replace(oneD=oneD)).balance(
            w, coords=coords)
        assert abs(got["dlb"][oneD] - float(r.imbalance)) <= 1e-5
        differ = (got["dlb"][f"parts_{oneD}"] != np.asarray(r.parts)).sum()
        assert differ <= 0.001 * n


def test_moe_balance_matches_reference_dispatch():
    from repro.models.moe import _dispatch_indices, dispatch_quality
    got, text = _quiet(W.load_example("moe_balance").main,
                       ["--device", "cpu"])
    assert "skewed router" in text
    rng = np.random.default_rng(0)
    e, k, s = 8, 2, 512
    want = []
    for skew in [0.0, 0.5, 1.0]:
        probs = np.exp(-skew * np.arange(e))
        probs /= probs.sum()
        items = jnp.asarray(rng.choice(e, size=s * k, p=probs), jnp.int32)
        q = dispatch_quality(items, e)
        for cf in [1.0, 1.25, 2.0]:
            cap = max(int(cf * s * k / e), 1)
            _, keep = _dispatch_indices(items, e, cap)
            want.append((skew, cf, float(q.imbalance),
                         1.0 - float(np.asarray(keep).mean())))
    assert got["dispatch"] == want
    fresh, skewed = got["aux"]
    assert 0.99 < fresh < 1.05 < skewed


@pytest.fixture
def one_thread():
    """One intra-op thread: the suite's workers share the machine's
    cores, and a training loop spread over all of them in each worker
    runs 20-40 times slower there than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_lm_checkpoints_and_resumes(tmp_path, one_thread):
    ex = W.load_example("train_lm")
    argv = ["--device", "cpu", "--seq", "64", "--batch", "2", "--ckpt",
            str(tmp_path / "ck")]
    first, text = _quiet(ex.main, argv + ["--steps", "26"])
    assert first["start"] == 0 and len(first["losses"]) == 26
    assert "model: 6.0M params" in text
    again, text = _quiet(ex.main, argv + ["--steps", "28", "--resume"])
    assert "resumed from step 25" in text
    assert again["start"] == 25 and len(again["losses"]) == 3
    assert np.isfinite(first["losses"] + again["losses"]).all()


def test_one_part_warm_ksection_raises_in_both_packages():
    """serve_continuous's groups are min(4, ranks): on one rank the
    balancer runs a k-section with p = 1, whose warm start (the previous
    call's empty splitters) meets an empty target set.  The JAX package
    raises in ``warm_start_boxes`` and so does the port; this pins the
    shared fault until either changes."""
    from repro.core import partition1d as jp1d
    from repro_torch.core import partition1d as tp1d
    keys = np.arange(12, dtype=np.float32)
    w = np.ones(12, np.float32)
    cold_t = tp1d.ksection(torch.as_tensor(keys), torch.as_tensor(w), 1)
    cold_j = jp1d.ksection(jnp.asarray(keys), jnp.asarray(w), 1)
    assert cold_t.splitters.shape == (0,) == np.asarray(
        cold_j.splitters).shape
    with pytest.raises(RuntimeError, match="must match the size"):
        tp1d.ksection(torch.as_tensor(keys), torch.as_tensor(w), 1,
                      warm=cold_t.splitters)
    with pytest.raises((TypeError, ValueError), match="incompatible shapes"):
        jp1d.ksection(jnp.asarray(keys), jnp.asarray(w), 1,
                      warm=cold_j.splitters)
