"""Tensor-parallel training on a model axis, on a gloo world of 4 CPU
ranks, against the JAX package's unsharded ``loss_fn`` and ``jax.grad``
on one device taking the whole batch.

Each case is a SMOKE config in float32, from the JAX package's init
carried across (``interop.tensors_from_jax``), on a ``(d, m)`` mesh
(``launch.mesh.make_mesh``) under the launcher's rules
(``train_rules``: heads or head_dim, MLP and recurrent width, vocab and
experts on "model"): each rank holds its slices
(``distributed.sharding.model_slices``), takes its data index's rows,
and its gradients are summed over the data group and all-gathered over
the model group into the one-rank layout.  The cases of the decoder,
MoE, VLM and encoder-decoder families run in both attention layouts:
the launcher's rules put head_dim on "model" at SMOKE (8 heads do not
divide the production axis of 16), and the same rules with the heads
on "model" instead reach the heads layout.  llama at 1x4 and 2x2 with
``tp_shardmap`` False and True (2x2 False with remat, so the model
group's sums run again in the backward pass); phi3.5-moe and grok (with
remat) at 1x4, whose experts sit on the model axis (``ep_shards`` 0);
qwen2-vl (M-RoPE) and whisper (cross-attention) at 1x2 (the world split
in two meshes of 2 ranks).  The hybrid (recurrentgemma: head_dim
attention, RG-LRU and GeGLU slices) and the SSM (mamba2: only the vocab
sliced, the mixers whole on every rank) at 1x2, 1x4 and 2x2, with
``tp_shardmap`` False and True.  The llama cases take the batch of the
reference's own ``test_tp_shardmap_parity`` (its mesh-sharded run is
red under JAX 0.9.0, so its unsharded ``loss_fn`` is the oracle); the
others ``random_batch(cfg, 4, 64, seed=0)``.

Limits: the loss within LOSS_RTOL relative (and the reference test's
1e-3 absolute), every leaf's gradient within GRAD_TOL of its max |g|:
a missing sum over the model group leaves a partial gradient, a doubled
one counts a replicated leaf's gradient m times, and either is far
outside it.  Ranks of a model group hold their replicated leaves'
gradients bit for bit; so do the ranks of a data group their slices'.
One launcher step at 2x2 gives one rank's parameters within 2 lr +
1e-5.  The vocab-parallel ``chunked_cross_entropy`` over 4 ranks equals
the reference's.  ``train_rules`` is the reference launcher's
adaptation for every architecture; recurrentgemma-2b at m = 3 raises on
its RG-LRU width.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_training import jax_batch
from repro import configs as jconfigs
from repro.models import init_model as j_init_model
from repro.models import loss_fn as j_loss_fn
from repro_torch import configs
from repro_torch.data import random_batch
from repro_torch.distributed.sharding import model_slices, narrow
from repro_torch.interop import params_from_jax, tensors_from_jax
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as launch
from repro_torch.models import init_model

import _torch_world as W

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
REF_LOSS_TOL = 1e-3         # test_tp_shardmap_parity's own limit
LR = 1e-3

BOTH_LAYOUTS = {
    "llama-1x4": ("llama3_8b", {}, 1, 4),
    "llama-1x4-shardmap": ("llama3_8b", {"tp_shardmap": True}, 1, 4),
    "llama-2x2-remat": ("llama3_8b", {"remat": True}, 2, 2),
    "llama-2x2-shardmap": ("llama3_8b", {"tp_shardmap": True}, 2, 2),
    "phi-1x4": ("phi35_moe_42b", {}, 1, 4),
    "grok-1x4-remat": ("grok_1_314b", {"remat": True}, 1, 4),
    "qwen2vl-1x2": ("qwen2_vl_72b", {}, 1, 2),
    "whisper-1x2": ("whisper_medium", {}, 1, 2),
}
RECURRENT = {
    f"{name}-{d}x{m}{'-shardmap' if sm else ''}": (
        arch, {"tp_shardmap": True} if sm else {}, d, m)
    for name, arch in (("recurrentgemma", "recurrentgemma_2b"),
                       ("mamba2", "mamba2_1_3b"))
    for d, m, sm in ((1, 2, False), (1, 4, False), (1, 4, True),
                     (2, 2, False), (2, 2, True))
}
#: key -> (arch, overrides, d, m, layout)
CASES = {**{f"{k}/{layout}": v + (layout,)
            for k, v in BOTH_LAYOUTS.items()
            for layout in ("head_dim", "heads")},
         **{f"{k}/head_dim": v + ("head_dim",)
            for k, v in RECURRENT.items()}}


def _reference_tokens(cfg):
    """``test_tp_shardmap_parity``'s tokens (labels = tokens)."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab, (4, 64)).astype(np.int32)
    return {"tokens": tokens, "labels": tokens}


def _batch(arch, cfg):
    if arch == "llama3_8b":
        return _reference_tokens(cfg)
    return random_batch(cfg, b=4, s=64, seed=0)


def _jax_pair(arch, overrides):
    jcfg = jconfigs.get_smoke(arch).replace(**overrides)
    cfg = configs.get_smoke(arch).replace(**overrides)
    return jcfg, cfg, j_init_model(jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    cases, want, jax_runs = {}, {}, {}
    for key, (arch, over, d, m, layout) in CASES.items():
        run = (arch, tuple(sorted(over.items())))
        if run not in jax_runs:
            jcfg, cfg, params = _jax_pair(arch, over)
            batch = _batch(arch, cfg)
            weights = {n: t.numpy() for n, t in
                       tensors_from_jax(params, cfg, device="cpu").items()}
            loss, grads = jax.value_and_grad(
                lambda p: j_loss_fn(p, jax_batch(batch), jcfg))(params)
            jax_runs[run] = (batch, weights, (float(loss), {
                n: g.numpy() for n, g in tensors_from_jax(
                    grads, cfg, device="cpu").items()}))
        batch, weights, want[key] = jax_runs[run]
        cases[key] = (arch, over, d, m, layout, batch, weights)
    cfg = configs.get_smoke("llama3_8b")
    launcher_batches = [_reference_tokens(cfg)]
    rng = np.random.default_rng(0)
    ce_case = (rng.standard_normal((2, 128, cfg.d_model)).astype(np.float32),
               rng.standard_normal((cfg.d_model, cfg.vocab)).astype(
                   np.float32) / np.sqrt(cfg.d_model),
               rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32))
    ranks = W.world(W.tp_world, cases, launcher_batches, ce_case,
                    tmp_path=tmp_path_factory.mktemp("tp"), p=4)
    return {"ranks": ranks, "want": want, "cases": cases,
            "launcher_batches": launcher_batches, "ce_case": ce_case}


@pytest.mark.parametrize("key", list(CASES))
def test_loss_matches_the_unsharded_reference(tp, key):
    want, _ = tp["want"][key]
    for res in tp["ranks"][:CASES[key][2] * CASES[key][3]]:
        assert abs(res[key]["loss"] - want) <= LOSS_RTOL * abs(want), key


@pytest.mark.parametrize("key", list(CASES))
def test_gradients_match_the_unsharded_reference(tp, key):
    _, want = tp["want"][key]
    got = tp["ranks"][0][key]["whole"]
    assert set(got) == set(want)
    for n, w in want.items():
        err = np.max(np.abs(got[n] - w))
        assert err <= GRAD_TOL * max(np.max(np.abs(w)), 1e-30), (n, err)


def _expected_slices(cfg, layout, names):
    """Which leaves the rules slice, by family and layout: the vocab at
    SMOKE; the attention's wq / wo (heads) or wq, wk, wv, wo (head_dim);
    the MLP's and the RG-LRU's width but its replicated vectors; the
    experts; never a norm, the router or a mamba2 mixer leaf."""
    attn = ("wq", "wo") if layout == "heads" else ("wq", "wk", "wv", "wo")
    rglru = ("in_x", "in_gate", "conv_w", "conv_b", "w_r", "w_i", "out")
    out = {"embed.tok", "embed.head"}
    for n in names:
        module, leaf = (["", ""] + n.split("."))[-2:]
        if (module in ("attn", "self_attn", "cross_attn") and leaf in attn
                or module == "rglru" and leaf in rglru
                or module == "mlp" or module == "moe" and leaf != "router"):
            out.add(n)
    return out


@pytest.mark.parametrize("key", list(CASES))
def test_ranks_agree_on_replicated_leaves_and_slices(tp, key):
    """The leaves the rules shard are really sliced on every rank (and no
    other); ranks of a model group hold equal gradients of their
    replicated leaves, ranks of a data group equal gradients of their
    slices, and every rank the same whole gradients."""
    arch, over, d, m, layout, _, _ = tp["cases"][key]
    ranks = [r[key] for r in tp["ranks"][:d * m]]
    assert [r["coords"] for r in ranks] == [
        (None if d == 1 else r // m, r % m) for r in range(d * m)]
    sliced = set(ranks[0]["sliced"])
    cfg = configs.get_smoke(arch).replace(**over)
    assert sliced == _expected_slices(cfg, layout, ranks[0]["whole"])
    for r in ranks:
        for n, g in r["whole"].items():
            np.testing.assert_array_equal(g, ranks[0]["whole"][n], n)
    for i in range(d):
        group = ranks[i * m:(i + 1) * m]
        for r in group:
            for n in set(r["local"]) - sliced:
                np.testing.assert_array_equal(r["local"][n],
                                              group[0]["local"][n], n)
    for j in range(m):
        for r in ranks[j::m]:
            for n in sliced:
                np.testing.assert_array_equal(r["local"][n],
                                              ranks[j]["local"][n], n)


def test_tp_shardmap_parity_reference_case(tp):
    """The reference's red ``test_tp_shardmap_parity`` (llama SMOKE,
    ``tp_shardmap=True``, its tokens), run by the port at 2x2: the loss
    within the reference's 1e-3 of its unsharded loss, and within the
    port's 1e-5 relative."""
    jcfg, cfg, params = _jax_pair("llama3_8b", {"tp_shardmap": True})
    ref = float(j_loss_fn(params, jax_batch(_reference_tokens(cfg)), jcfg))
    got = tp["ranks"][0]["llama-2x2-shardmap/head_dim"]["loss"]
    assert abs(got - ref) < REF_LOSS_TOL
    assert abs(got - ref) <= LOSS_RTOL * abs(ref)


def test_vocab_parallel_chunked_cross_entropy(tp):
    """``layers.chunked_cross_entropy`` with the head's vocab columns over
    4 model ranks (a vocab-parallel logsumexp and gold logit) against the
    reference's on the whole head: the loss within LOSS_RTOL, its
    gradients with respect to the hidden states and the head within
    GRAD_TOL of their max |g|, on every rank alike."""
    from repro.models.layers import chunked_cross_entropy as j_ce
    from repro.distributed.sharding import box
    x, head, labels = tp["ce_case"]
    jcfg = jconfigs.get_smoke("llama3_8b")
    loss, (gx, gh) = jax.value_and_grad(
        lambda a, h: j_ce(box(h, ("embed", "vocab")), a, labels, jcfg),
        argnums=(0, 1))(x, head)
    for r in tp["ranks"]:
        got = r["chunked_ce"]
        assert abs(got["loss"] - float(loss)) <= LOSS_RTOL * float(loss)
        for g, w in ((got["grad_x"], gx), (got["grad_head"], gh)):
            w = np.asarray(w)
            assert np.max(np.abs(g - w)) <= GRAD_TOL * np.max(np.abs(w))


def test_launcher_step_at_2x2_equals_one_rank(tp):
    """``launch.train.train`` at 2x2 (data and model groups of 2) takes
    one step from the seed-0 init like one rank on the whole batch:
    parameters within 2 lr + 1e-5, the loss within LOSS_RTOL."""
    cfg = configs.get_smoke("llama3_8b")
    one = launch.train(cfg, steps=1, batch=4, seq=64, lr=LR, ckpt=None,
                       device="cpu", batches=iter(tp["launcher_batches"]),
                       log=lambda *a: None)
    got = tp["ranks"][0]["launcher"]
    for n, p in one["model"].named_parameters():
        err = np.max(np.abs(got["params"][n] - p.detach().numpy()))
        assert err <= 2 * LR + 1e-5, (n, err)
    loss = one["history"][0]["loss"]
    assert abs(got["history"][0]["loss"] - loss) <= LOSS_RTOL * loss
    rec = got["history"][0]
    assert rec["model_bytes"] > 0 and rec["t_model"] > 0.0
    for r in tp["ranks"][1:]:
        assert r["launcher"]["history"][0]["loss"] == rec["loss"]


@pytest.mark.parametrize("arch", ["llama3_8b", "phi35_moe_42b",
                                  "whisper_medium", "qwen2_vl_72b",
                                  "recurrentgemma_2b", "mamba2_1_3b"])
def test_rank_slices_equal_the_one_rank_init(arch):
    """``init_model(..., slices=)`` draws every leaf whole in the
    one-rank order and keeps the slice: each model rank's parameters are
    the slices of ``init_model(cfg, seed=0)``; ``params_from_jax`` with
    slices builds the same slices of the JAX package's weights."""
    cfg = configs.get_smoke(arch)
    whole = dict(init_model(cfg, seed=0, device="cpu").named_parameters())
    jcfg, _, params = _jax_pair(arch, {})
    jwhole = tensors_from_jax(params, cfg, device="cpu")
    rules = mesh_mod.train_rules(cfg, 4)
    for i in range(4):
        slices = model_slices(cfg, rules, 4, i)
        assert any(s is not None for s in slices.values())
        part = dict(init_model(cfg, seed=0, device="cpu",
                               slices=slices).named_parameters())
        jpart = dict(params_from_jax(params, cfg, device="cpu",
                                     slices=slices).named_parameters())
        for n, w in whole.items():
            assert torch.equal(part[n], narrow(w, slices[n])), n
            assert torch.equal(jpart[n], narrow(jwhole[n], slices[n])), n


def _reference_launcher_rules(jcfg, m):
    """The rules ``repro.launch.train.main`` trains with on a (d, m)
    mesh: its production rules, then its own loop dropping "model" from
    each axis whose dim ``m`` does not divide (``launch/train.py``
    lines 64-71, which live inside ``main``)."""
    from repro.launch.mesh import arch_rules
    rules = arch_rules(jcfg.name, jcfg, multi_pod=False)
    for name in ("heads", "mlp", "vocab", "expert", "head_dim"):
        dim = {"heads": jcfg.n_heads, "mlp": max(jcfg.d_ff, 1),
               "vocab": jcfg.vocab, "expert": max(jcfg.n_experts, 1),
               "head_dim": jcfg.hd}[name]
        if rules.get(name) == "model" and dim % m != 0:
            rules[name] = None
    return rules


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_rules_are_the_reference_launchers(arch, m):
    """``train_rules(cfg, m)`` is the reference launcher's adaptation of
    its production rules, for the published config and its SMOKE, every
    family alike (no axis swapped, no family refused)."""
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke, jconfigs.get_smoke)):
        want = _reference_launcher_rules(jget(arch), m)
        assert mesh_mod.train_rules(get(arch), m) == want, get.__name__


def test_mesh_rules_as_the_launcher_prints_them():
    """What the launcher's rules do to the last two families: mamba2's
    mixer keeps nothing on "model" on any small mesh (``d_ff = 0``), its
    vocab of 50,280 only at SMOKE; recurrentgemma-2b puts head_dim, the
    MLP and RG-LRU width and the vocab there at m = 2 and 4, and at
    m = 3 keeps "mlp" (7,680 divides 3), which the RG-LRU width of 2,560
    does not split: ``model_slices`` raises naming that leaf.  At m = 1
    nothing is sliced."""
    mamba, rg = (configs.get_config(a) for a in ("mamba2_1_3b",
                                                 "recurrentgemma_2b"))
    for m in (2, 3, 4):
        assert not any(model_slices(mamba, mesh_mod.train_rules(mamba, m),
                                    m, 0).values())
    smoke = configs.get_smoke("mamba2_1_3b")
    sl = model_slices(smoke, mesh_mod.train_rules(smoke, 2), 2, 1)
    assert {n for n, s in sl.items() if s} == {"embed.tok", "embed.head"}
    for m in (2, 4):
        rules = mesh_mod.train_rules(rg, m)
        assert {a for a, v in rules.items() if v == "model"} == {
            "head_dim", "mlp", "vocab"}
        sl = model_slices(rg, rules, m, m - 1)
        assert sl["layers.2.attn.wq"] == (2, (m - 1) * 256 // m, 256 // m)
        assert sl["layers.0.rglru.w_r"] == (0, (m - 1) * 2560 // m, 2560 // m)
        assert sl["layers.0.rglru.b_r"] is None
    assert {a for a, v in mesh_mod.train_rules(rg, 3).items()
            if v == "model"} == {"mlp"}
    with pytest.raises(ValueError, match=r"layers\.0\.rglru\.in_x"):
        model_slices(rg, mesh_mod.train_rules(rg, 3), 3, 0)
    assert not any(model_slices(rg, mesh_mod.train_rules(rg, 1), 1,
                                0).values())
