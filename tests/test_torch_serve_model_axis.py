"""Serving on the model axis (``serve.decode.prefill`` / ``decode_step``
with ``model=`` and ``slices=``) on gloo worlds of CPU ranks, against the
JAX package's unsharded ``prefill`` / ``decode_step`` on the same
weights (the JAX package's SMOKE init carried across with
``interop.params_from_jax``) and tokens (numpy, fixed seeds).

Each case runs on model groups of 2 and of 4 ranks under
``launch.mesh.serve_rules``: the KV cache's sequence split over the
ranks, the MLP, RG-LRU width, vocab and experts sliced where ``m``
divides them; "llama3_8b/heads" also slices the query heads (GQA: 8
query heads over 2 K/V heads).  The prompts wrap danube3's window ring
(32) and recurrentgemma's, and the decode steps write on every rank's
block.  Tolerance (float32): every logit within 1e-5 of the largest
reference logit (sums in another order).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import init_model as j_init_model
from repro.serve import decode as JD
from repro_torch import configs
from repro_torch.interop import params_from_jax

import _torch_world as W

TOL = 1e-5
B, STEPS = 2, 5

#: key -> (arch, overrides, heads on "model", prompt length, max_seq)
FAMILIES = {
    "llama3_8b": ("llama3_8b", {}, False, 24, 64),
    "llama3_8b/heads": ("llama3_8b", {}, True, 24, 64),
    "h2o_danube3_4b/ring": ("h2o_danube3_4b", {}, False, 45, 64),
    "phi35_moe_42b": ("phi35_moe_42b", {}, False, 20, 32),
    "mamba2_1_3b": ("mamba2_1_3b", {}, False, 24, 64),
    "recurrentgemma_2b/ring": ("recurrentgemma_2b", {}, False, 45, 64),
    "whisper_medium": ("whisper_medium", {}, False, 12, 32),
}
MS = (2, 4)
CASES = [(k, m) for k in FAMILIES for m in MS]


def _inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    steps = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
             for _ in range(STEPS)]
    return batch, steps


_PREFILL = jax.jit(JD.prefill, static_argnums=(2,),
                   static_argnames=("max_seq",))
_DECODE = jax.jit(JD.decode_step, static_argnums=(3,))


def _reference(jcfg, params, batch, steps, max_seq):
    """The reference's prefill and decode steps, jitted (eager dispatch of
    the recurrent families' ops takes a minute)."""
    logits, state = _PREFILL(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, jcfg,
                             max_seq=max_seq)
    out = [np.asarray(logits)]
    for tok in steps:
        logits, state = _DECODE(params, state, jnp.asarray(tok), jcfg)
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' results (the world runs in a thread) and the
    reference's logits, computed meanwhile."""
    cases, refs = {}, {}
    for i, (key, (arch, over, heads, s, max_seq)) in enumerate(
            FAMILIES.items()):
        jcfg = jconfigs.get_smoke(arch).replace(**over)
        cfg = configs.get_smoke(arch).replace(**over)
        params = j_init_model(jcfg, jax.random.PRNGKey(i))
        weights = {n: p.numpy().copy() for n, p in params_from_jax(
            params, cfg, device="cpu").named_parameters()}
        batch, steps = _inputs(cfg, s, seed=70 + i)
        refs[key] = (jcfg, params, batch, steps, max_seq)
        for m in MS:
            cases[f"{key}@{m}"] = (arch, over, heads, m, weights, batch,
                                   steps, max_seq)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(W.world, W.serve_model_axis_world, cases,
                            tmp_path=tmp_path_factory.mktemp("serve_axis"),
                            p=4)
        want = {k: _reference(*r) for k, r in refs.items()}
        return {"ranks": ranks.result(), "want": want}


@pytest.mark.parametrize("key,m", CASES)
def test_model_axis_serving_matches_the_unsharded_reference(served, key, m):
    """The prefill's and every decode step's logits on each rank of the
    model group equal the reference's, and the step slices what the
    rules slice."""
    want = served["want"][key]
    for rank in served["ranks"]:
        got = rank[f"{key}@{m}"]
        assert len(got["logits"]) == len(want)
        for t, (g, w) in enumerate(zip(got["logits"], want)):
            assert g.shape == w.shape, (t, g.shape, w.shape)
            err = float(np.max(np.abs(g - w)))
            assert err <= TOL * max(float(np.max(np.abs(w))), 1.0), (t, err)
        # the MLP, the RG-LRU or the experts, and the vocab (512) are
        # sliced; mamba2's mixers stay whole
        assert any(n.startswith("embed.") for n in got["sliced"])
        if key.startswith("mamba2"):
            assert not any(".mixer." in n for n in got["sliced"])
        else:
            assert any(n.endswith((".wi", ".in_x")) for n in got["sliced"])
        if key.endswith("/heads"):
            assert any(n.endswith("attn.wq") for n in got["sliced"])


@pytest.mark.parametrize("m", MS)
def test_decode_collectives_by_kind(served, m):
    """With the heads sliced, decode all-gathers q (every step and layer)
    and combines the softmax with all-reduces; with the attention whole
    on every rank nothing is gathered but the logits' columns."""
    heads = served["ranks"][0][f"llama3_8b/heads@{m}"]["bytes"]
    whole = served["ranks"][0][f"llama3_8b@{m}"]["bytes"]
    cfg = configs.get_smoke("llama3_8b")
    # q of every layer and step: (b, h, 1, hd) float32 gathered
    q = cfg.n_layers * STEPS * B * cfg.n_heads * cfg.hd * 4
    logits = (STEPS + 1) * B * cfg.vocab * 4
    assert whole["all-gather"] == logits
    assert heads["all-gather"] == logits + q
    assert heads["all-reduce"] > 0 and heads["reduce-scatter"] == 0
