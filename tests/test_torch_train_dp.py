"""Data-parallel training on a gloo world of 4 CPU ranks, against the JAX
package on one device taking the whole batch.

The reference's semantics: one global batch, of which rank r takes the
contiguous rows ``[r B/4, (r+1) B/4)``; each rank's loss term
(``loss_fn(..., data=comm)``: the cross-entropy over the global label
count, the MoE aux over the global expert counts) gives gradients that
the step sums over the ranks in float32; the AdamW moments are sharded
ZeRO-style.  The SMOKE llama, phi3.5-moe (with remat, so the MoE's
all-reduce runs again in the backward pass) and whisper configs run in
float32 on global batches of 8 rows, from the JAX package's init carried
across (``interop.params_from_jax``).

Tolerances: the summed gradients within GRAD_TOL of each leaf's max |g|
of ``jax.value_and_grad(repro.models.loss_fn)`` on the whole batch, and
the global loss (and the sum of the ranks' terms) within LOSS_RTOL of
its loss, relative (the ranks sum their rows in another order than one
device, and the two packages sum in other orders).  The ZeRO update and
``compress=True`` are held bit for bit against one rank's
``adamw_update`` (and ``ef_compress_grads``) given the same summed
gradients; every rank's parameters are equal bit for bit.  A checkpoint
saved at D = 4 resumes at D = 1 and D = 2 bit for bit like the same
steps taken from the D = 4 run's state held in memory.  One world serves
the whole file.  The ranks run one CPU thread each, and a sum over a
tensor adds in an order that follows the thread count, so the one-rank
replays here run on one thread too.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from _torch_training import jax_batch, smoke_pair
from repro.models import loss_fn as j_loss_fn
from repro_torch import configs
from repro_torch.data import random_batch
from repro_torch.interop import tensors_from_jax
from repro_torch.models import init_model
from repro_torch.train import (AdamWConfig, CompressState, OptState,
                               adamw_update, ef_compress_grads,
                               init_opt_state)

import _torch_world as W

CASES = [("llama3_8b", {}), ("phi35_moe_42b", {"remat": True}),
         ("whisper_medium", {})]
ARCHS = [a for a, _ in CASES]
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-6


def _cfg(arch, overrides):
    return configs.get_smoke(arch).replace(**overrides)


def _batches(cfg, seed):
    return [random_batch(cfg, b=8, s=64, seed=seed + i) for i in range(2)]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    pairs = {a: smoke_pair(a, **o) for a, o in CASES}
    cases = [(a, o, _batches(_cfg(a, o), 10 * i),
              {n: t.detach().numpy() for n, t in
               pairs[a][3].named_parameters()})
             for i, (a, o) in enumerate(CASES)]
    elastic = _batches(configs.get_smoke("llama3_8b"), 100)
    mesh_case = (_batches(configs.get_smoke("llama3_8b"), 200)[0],
                 cases[0][3])
    ranks = W.world(W.dp_world, cases, elastic,
                    str(tmp_path_factory.mktemp("ckpt")), mesh_case,
                    tmp_path=tmp_path_factory.mktemp("dp"), p=4)
    return {"cases": {a: (o, b, w) for a, o, b, w in cases},
            "pairs": pairs, "elastic": elastic, "ranks": ranks,
            "mesh_case": mesh_case}


def _jax_whole_batch(pair, batch):
    """(loss, {name: grad}) of the JAX package on one device taking the
    whole batch, the gradients by the port's parameter names."""
    jcfg, cfg, params, _ = pair
    jb = jax_batch(batch)
    loss, grads = jax.value_and_grad(lambda p: j_loss_fn(p, jb, jcfg))(params)
    return float(loss), {n: g.numpy() for n, g in
                         tensors_from_jax(grads, cfg, device="cpu").items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_summed_gradients_match_one_rank(dp, arch):
    """The ranks' summed gradients, the global loss and the sum of the
    ranks' terms against the reference's one device on the whole
    batch."""
    _, batches, _ = dp["cases"][arch]
    loss, want = _jax_whole_batch(dp["pairs"][arch], batches[0])
    first = dp["ranks"][0][arch]
    assert set(first["grads"]) == set(want)
    for n, w in want.items():
        err = np.max(np.abs(first["grads"][n] - w))
        assert err <= GRAD_TOL * max(np.max(np.abs(w)), 1e-30), (n, err)
    assert abs(first["loss"] - loss) <= LOSS_RTOL * abs(loss)
    # the ranks' terms sum to the global loss
    terms = sum(r[arch]["term"] for r in dp["ranks"])
    assert abs(terms - loss) <= LOSS_RTOL * abs(loss)


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@_one_thread()
def _replay(arch, overrides, weights, steps, compress):
    """One rank's updates from ``weights`` given each step's summed
    gradients: (params after each step, m, v, gnorms)."""
    cfg = _cfg(arch, overrides)
    ocfg = AdamWConfig(**W.DP_OPT)
    model = W.model_from_numpy(cfg, weights)
    opt = init_opt_state(model, ocfg)
    comp: CompressState = None
    params, gnorms = [], []
    for st in steps:
        grads = {n: torch.as_tensor(g) for n, g in st["grads"].items()}
        if compress:
            grads, comp = ef_compress_grads(grads, comp, cfg)
        opt, info = adamw_update(model, grads, opt, ocfg)
        params.append({n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()})
        gnorms.append(float(info["gnorm"]))
    return params, opt, gnorms


@pytest.mark.parametrize("compress", [False, True], ids=["zero", "compress"])
@pytest.mark.parametrize("arch", ARCHS)
def test_update_is_one_ranks_bit_for_bit(dp, arch, compress):
    """Parameters after each step, gathered m and v and gnorm: the ZeRO
    update (and the error feedback on the summed gradients) equals one
    rank's given the same gradients."""
    overrides, _, weights = dp["cases"][arch]
    res = dp["ranks"][0][arch]["compress" if compress else "zero"]
    params, opt, gnorms = _replay(arch, overrides, weights, res["steps"],
                                  compress)
    for st, want, g in zip(res["steps"], params, gnorms):
        assert st["gnorm"] == g
        for n, w in want.items():
            np.testing.assert_array_equal(st["params"][n], w, err_msg=n)
    for n in opt.m:
        np.testing.assert_array_equal(res["m"][n], opt.m[n].numpy(), n)
        np.testing.assert_array_equal(res["v"][n], opt.v[n].numpy(), n)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_agrees(dp, arch):
    first = dp["ranks"][0][arch]
    for res in dp["ranks"][1:]:
        for name in ("zero", "compress"):
            for a, b in zip(first[name]["steps"], res[arch][name]["steps"]):
                assert a["loss"] == b["loss"] and a["gnorm"] == b["gnorm"]
                for n in a["params"]:
                    np.testing.assert_array_equal(a["params"][n],
                                                  b["params"][n], n)
                    np.testing.assert_array_equal(a["grads"][n],
                                                  b["grads"][n], n)


@pytest.mark.parametrize("arch", ARCHS)
def test_moments_are_sharded(dp, arch):
    """Each rank holds a quarter of every leaf the ZeRO rule splits (the
    embedding width at SMOKE: 2 layers do not split over 4 ranks), the
    whole of a replicated one; its bytes on the wire are its parts'."""
    overrides, _, _ = dp["cases"][arch]
    cfg = _cfg(arch, overrides)
    shapes = {n: tuple(p.shape) for n, p in
              init_model(cfg, seed=None, device="meta").named_parameters()}
    split = 0
    for rank, res in enumerate(dp["ranks"]):
        z = res[arch]["zero"]
        for n, (dim, start, size, owner) in z["shards"].items():
            local = list(shapes[n])
            if dim is not None:
                assert size * 4 == shapes[n][dim] and start == rank * size
                local[dim] = size
                split += 1
            assert owner is None
            assert z["local_m"][n] == tuple(local), n
        step = z["steps"][0]
        assert step["reduce_bytes"] == 4 * sum(
            int(np.prod(s)) for s in shapes.values())
    assert split > 0


def test_elastic_checkpoint_resumes_at_another_size(dp):
    """Saved at D = 4 in the one-rank layout; resumed at D = 1 and D = 2
    (where the 2 layers split over the 2 ranks by layer), each continues
    bit for bit like the same steps from the D = 4 state in memory; at
    D = 2 each rank restores its slice of the moments, and the ZeRO
    update by layer equals one rank's given the same gradients."""
    ranks = [r["elastic"] for r in dp["ranks"]]
    saved = ranks[0]["saved"]
    for r in ranks[1:]:
        for n in saved["params"]:
            np.testing.assert_array_equal(r["saved"]["m"][n],
                                          saved["m"][n], n)
    for d in (1, 2):
        for rank in range(d):
            res = ranks[rank][d]
            assert res["start"] == 2
            for n, w in res["memory_params"].items():
                np.testing.assert_array_equal(res["params"][n], w, n)
    owned = 0
    for rank in range(2):
        res = ranks[rank][2]
        for n, (dim, start, size, owner) in res["shards"].items():
            full = saved["m"][n]
            if owner is not None:
                owned += 1
                if owner != rank:
                    assert n not in res["restored_m"]
                    continue
            want = (full if dim is None else
                    np.take(full, range(start, start + size), axis=dim))
            np.testing.assert_array_equal(res["restored_m"][n], want, n)
    assert owned > 0
    cfg = configs.get_smoke("llama3_8b")
    ocfg = AdamWConfig(lr=1e-3, warmup=1, total_steps=4)
    model = init_model(cfg, seed=None, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(saved["params"][n]))
    opt = OptState(2, {n: torch.as_tensor(a).clone()
                       for n, a in saved["m"].items()},
                   {n: torch.as_tensor(a).clone()
                    for n, a in saved["v"].items()})
    with _one_thread():
        for g in ranks[0][2]["memory_grads"]:
            opt, _ = adamw_update(model, {n: torch.as_tensor(a)
                                          for n, a in g.items()}, opt, ocfg)
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(ranks[0][2]["memory_params"][n],
                                      p.detach().numpy(), n)


def test_zero_shards_split_local_slices_at_2x2(dp):
    """On a 2x2 mesh each rank's moments are ZeRO shards of its model
    slices: a dim on "model" is never the ZeRO dim, a split dim gives
    the rank its half of the slice (by data rank), the moments have the
    part's shape, and the rank of the other data index holds the other
    half of the same slice."""
    ranks = [r["mesh_2x2"] for r in dp["ranks"]]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    split = 0
    for r in ranks:
        for n, (dim, start, size, owner) in r["shards"].items():
            sl, local = r["slices"][n], list(r["local"][n])
            if sl is not None:
                assert dim != sl[0], n
                assert local[sl[0]] == sl[2]
            if owner is not None:                 # a layer owned whole
                if owner == r["coords"][0]:
                    assert r["local_m"][n] == tuple(local)
                else:
                    assert n not in r["local_m"]
                continue
            if dim is not None:
                assert size * 2 == local[dim] and start == r["coords"][0] * size
                local[dim] = size
                split += sl is not None
            assert r["local_m"][n] == tuple(local), n
    assert split > 0
    for a, b in ((0, 2), (1, 3)):           # one model index, two data
        assert ranks[a]["slices"] == ranks[b]["slices"]


def test_global_norm_at_2x2_matches_one_rank(dp):
    """The clip norm on a 2x2 mesh (the sliced leaves' squares summed
    over the model group, each replicated leaf counted once) against one
    rank's on the whole batch, within 1e-6 relative; equal on every
    rank."""
    from repro_torch.models import loss_fn
    from repro_torch.train.optimizer import _global_norm
    batch, weights = dp["mesh_case"]
    cfg = configs.get_smoke("llama3_8b")
    model = W.model_from_numpy(cfg, weights)
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()},
                   cfg)
    want = float(_global_norm(dict(zip(names,
                                       torch.autograd.grad(loss, params)))))
    got = [r["mesh_2x2"]["gnorm"] for r in dp["ranks"]]
    assert got == [got[0]] * 4
    assert abs(got[0] - want) <= 1e-6 * want
