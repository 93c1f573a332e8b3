"""The model axis's new pieces alone, on a gloo world of 4 CPU ranks,
against the JAX package on one device:

* the head_dim layout of ``models.layers.attention_apply`` (the
  reference's rule where the heads do not divide the production axis):
  each rank holds its block of every head's dims of ``wq``, ``wk``,
  ``wv`` and ``wo``, against the reference's ``attention_apply`` on the
  whole weights, with RoPE (llama, grok's soft cap), a sliding window
  over several KV chunks (recurrentgemma, chunked and blocked causal),
  M-RoPE (qwen2-vl) and cross-attention to an encoder of another length
  (whisper, K/V projected from the rank's blocks as the decoder block
  does);
* the RG-LRU block and its gates on a rank's channels (recurrentgemma),
  against the reference's ``rglru_block_apply`` and ``_gates``;
* the hybrid's elastic checkpoint: saved at 2x2, restored and saved at
  1x4 and at 2x2 again bit for bit, and resumed at 1x4 and at 1x1 alike.

Inputs and weights are drawn with numpy from fixed seeds, float32.
Limits: outputs within TOL of their max |y|, every gradient within TOL
of its max |g| (a sum over the group missed or doubled is far outside).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed.sharding import box
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro_torch import configs

import _torch_world as W

TOL = 1e-5
F32 = jnp.float32

#: key -> (arch, overrides, model ranks, inputs beyond x)
ATTENTION = {
    "rope-llama-m4": ("llama3_8b", {}, 4, ()),
    "rope-softcap-grok-m4": ("grok_1_314b", {}, 4, ()),
    "window-chunked-m4": ("recurrentgemma_2b", {"attn_chunk": 16}, 4, ()),
    "window-blocked-m2": ("recurrentgemma_2b",
                          {"attn_chunk": 16, "causal_blocked_attn": True}, 2,
                          ()),
    "mrope-qwen2vl-m2": ("qwen2_vl_72b", {}, 2, ("pos3",)),
    "cross-whisper-m2": ("whisper_medium", {}, 2, ("enc",)),
}
RGLRU_M = (2, 4)
B, S, S_ENC = 2, 64, 48


def _attention_inputs(cfg, extra, seed):
    rng = np.random.default_rng(seed)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    weights = {
        "wq": rng.standard_normal((d, h, hd)) / np.sqrt(d),
        "wk": rng.standard_normal((d, hkv, hd)) / np.sqrt(d),
        "wv": rng.standard_normal((d, hkv, hd)) / np.sqrt(d),
        "wo": rng.standard_normal((h, hd, d)) / np.sqrt(h * hd)}
    inputs = {"x": rng.standard_normal((B, S, d)),
              "pos": np.broadcast_to(np.arange(S), (B, S)).copy(),
              "r": rng.standard_normal((B, S, d))}
    if "pos3" in extra:
        inputs["pos3"] = np.sort(rng.integers(0, S, (3, B, S)), axis=-1)
    if "enc" in extra:
        inputs["enc"] = rng.standard_normal((B, S_ENC, d))
    f32 = lambda a: a.astype(np.float32) if a.dtype.kind == "f" else \
        a.astype(np.int32)  # noqa: E731
    return ({k: f32(v) for k, v in inputs.items()},
            {k: f32(v) for k, v in weights.items()})


def _jax_attention(jcfg, inputs, weights):
    """The reference's output and gradients of sum(y * r)."""
    axes = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}
    leaves = {"x": inputs["x"], **weights}
    if "enc" in inputs:
        leaves["enc"] = inputs["enc"]

    def f(lv):
        params = {k: box(lv[k], axes[k]) for k in axes}
        if "enc" in lv:
            kv = tuple(jnp.einsum("bsd,dhk->bhsk", lv["enc"], lv[w],
                                  preferred_element_type=F32).astype(
                                      jcfg.act_dtype) for w in ("wk", "wv"))
            y = jlayers.attention_apply(params, lv["x"], jcfg,
                                        pos=inputs["pos"], causal=False,
                                        kv_override=kv)
        else:
            y = jlayers.attention_apply(params, lv["x"], jcfg,
                                        pos=inputs["pos"], causal=True,
                                        pos3=inputs.get("pos3"))
        return jnp.sum(y * inputs["r"]), y

    (_, y), g = jax.jit(jax.value_and_grad(f, has_aux=True))(leaves)
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


def _rglru_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    d, w = cfg.d_model, cfg.lru_width
    weights = {
        "in_x": rng.standard_normal((d, w)) / np.sqrt(d),
        "in_gate": rng.standard_normal((d, w)) / np.sqrt(d),
        "conv_w": rng.standard_normal((w, 4)) * 0.1,
        "conv_b": rng.standard_normal(w) * 0.1,
        "w_r": rng.standard_normal((w, w)) / np.sqrt(w),
        "b_r": rng.standard_normal(w) * 0.5,
        "w_i": rng.standard_normal((w, w)) / np.sqrt(w),
        "b_i": rng.standard_normal(w) * 0.5,
        "lam": rng.uniform(1.0, 6.0, w),
        "out": rng.standard_normal((w, d)) / np.sqrt(w)}
    inputs = {"x": rng.standard_normal((B, S, d)),
              "r": rng.standard_normal((B, S, d)),
              "xc": rng.standard_normal((B, S, w)),
              "ra": rng.standard_normal((B, S, w)),
              "rb": rng.standard_normal((B, S, w))}
    as32 = lambda dct: {k: v.astype(np.float32)  # noqa: E731
                        for k, v in dct.items()}
    return as32(inputs), as32(weights)


def _jax_rglru(jcfg, inputs, weights):
    """The reference's block output and gradients of sum(y * r); its
    gates and the gradients of sum(a * ra + b * rb)."""
    def params_of(wt):
        return {k: box(v, (None,) * v.ndim) for k, v in wt.items()}

    def block(x, wt):
        y = jrglru.rglru_block_apply(params_of(wt), x, jcfg)
        return jnp.sum(y * inputs["r"]), y

    (_, y), (gx, gw) = jax.jit(jax.value_and_grad(
        block, argnums=(0, 1), has_aux=True))(inputs["x"], weights)

    def gates(xc, wt):
        a, b = jrglru._gates(params_of(wt), xc)
        return jnp.sum(a * inputs["ra"] + b * inputs["rb"]), (a, b)

    (_, (a, b)), (gxc, gwg) = jax.jit(jax.value_and_grad(
        gates, argnums=(0, 1), has_aux=True))(inputs["xc"], weights)
    np_ = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return {"y": np.asarray(y), "grads": {"x": np.asarray(gx), **np_(gw)},
            "gates": {"a": np.asarray(a), "b": np.asarray(b), "grads": {
                "xc": np.asarray(gxc),
                **{k: np.asarray(gwg[k]) for k in W.GATE_LEAVES}}}}


@pytest.fixture(scope="module")
def axis(tmp_path_factory):
    attn_cases, attn_want = {}, {}
    for i, (key, (arch, over, m, extra)) in enumerate(ATTENTION.items()):
        jcfg = jconfigs.get_smoke(arch).replace(**over)
        inputs, weights = _attention_inputs(jcfg, extra, seed=40 + i)
        attn_cases[key] = (arch, over, m, inputs, weights)
        attn_want[key] = _jax_attention(jcfg, inputs, weights)
    jcfg = jconfigs.get_smoke("recurrentgemma_2b")
    inputs, weights = _rglru_inputs(jcfg, seed=60)
    rglru_cases = {m: (m, inputs, weights) for m in RGLRU_M}
    rglru_want = _jax_rglru(jcfg, inputs, weights)
    from repro_torch.data import random_batch
    cfg = configs.get_smoke("recurrentgemma_2b")
    batches = [random_batch(cfg, b=4, s=64, seed=500 + i) for i in range(3)]
    ranks = W.world(W.model_axis_world, attn_cases, rglru_cases,
                    (batches, str(tmp_path_factory.mktemp("hybrid_ckpt"))),
                    tmp_path=tmp_path_factory.mktemp("axis"), p=4)
    return {"ranks": ranks, "attention": attn_want, "rglru": rglru_want}


def _close(got, want, what):
    err = np.max(np.abs(got - want))
    assert err <= TOL * max(np.max(np.abs(want)), 1e-30), (what, err)


@pytest.mark.parametrize("key", list(ATTENTION))
def test_head_dim_attention_matches_the_reference(axis, key):
    """Every rank's output and whole gradients (x, enc, each weight
    gathered from the ranks' blocks) equal the reference's on the whole
    weights."""
    y, grads = axis["attention"][key]
    for r in axis["ranks"]:
        got = r["attention"][key]
        _close(got["y"], y, "y")
        assert set(got["grads"]) == set(grads)
        for n, w in grads.items():
            _close(got["grads"][n], w, n)


@pytest.mark.parametrize("m", RGLRU_M)
def test_rglru_block_on_a_slice_matches_the_reference(axis, m):
    """The RG-LRU block on each rank's channels: the output, and the
    gradients of x and every leaf (the replicated b_r, b_i and lam summed
    over the group) in the one-rank layout."""
    want = axis["rglru"]
    for r in axis["ranks"]:
        got = r["rglru"][m]
        _close(got["y"], want["y"], "y")
        for n, w in want["grads"].items():
            _close(got["grads"][n], w, n)


@pytest.mark.parametrize("m", RGLRU_M)
def test_rglru_gates_on_a_slice_match_the_reference(axis, m):
    """``_gates`` on each rank's channels of the conv output: the gate
    products summed over the ranks' rows of w_r / w_i, cut to the rank's
    channels; the outputs gathered and every gradient whole."""
    want = axis["rglru"]["gates"]
    for r in axis["ranks"]:
        got = r["rglru"][m]["gates"]
        _close(got["a"], want["a"], "a")
        _close(got["b"], want["b"], "b")
        for n, w in want["grads"].items():
            _close(got["grads"][n], w, n)


def test_hybrid_elastic_checkpoint_moves_between_meshes(axis):
    """recurrentgemma saved at 2x2 (the RG-LRU, head_dim and vocab slices
    and their ZeRO'd moments gathered into the one-rank layout),
    restored and saved again at 1x4 and from that at 2x2: every array
    equal bit for bit to the first save; runs resumed at 1x4 and at 1x1
    start at step 2 and take the next step alike (within 1e-6)."""
    from repro_torch.train.checkpoint import read_checkpoint
    elastic = axis["ranks"][0]["elastic"]
    step, want = read_checkpoint(elastic["dirs"]["2x2"])
    assert step == 2 and any(".rglru.w_r" in k for k in want)
    for k in ("1x4", "2x2b"):
        got_step, got = read_checkpoint(elastic["dirs"][k])
        assert got_step == 2 and set(got) == set(want), k
        for n, w in want.items():
            assert got[n].dtype == w.dtype and torch.equal(got[n], w), (k, n)
    resumed = elastic["resumed"]
    assert resumed[4]["start"] == resumed[1]["start"] == 2
    for n, w in resumed[1]["params"].items():
        assert np.max(np.abs(resumed[4]["params"][n] - w)) <= 1e-6, n
