"""The encoder-decoder family (whisper: a non-causal encoder over stub
frame embeddings, a decoder with cross-attention, the plain GELU MLP,
sinusoidal positions) against the JAX package, on the CPU.

The JAX package's SMOKE config (2 + 2 layers, 64 frames) is initialised
by the JAX package and carried across with ``interop.params_from_jax``;
inputs are drawn with numpy.  The reference runs its plain attention
(``use_pallas=False``): its flash path cannot run whisper (the Pallas
kernel takes one length for Q and K/V, and its off-TPU fallback builds a
square mask).  The port runs both its routes; on CPU tensors the flash
route is ``kernels.ref.mha_ref``.  Tolerance in float32: 1e-5 of the
largest reference value (sums in another order).  In bf16: one bf16 step
per element on the same inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_model as j_init_model
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import ServeSession as JSession
from repro.serve import ServeSpec as JSpec
from repro.serve import bursty_trace as j_bursty_trace
from repro.serve import decode as JD
from repro.serve import run_trace as j_run_trace
from repro.serve.slots import slot_axes as j_slot_axes
from repro.serve.slots import slot_nbytes as j_slot_nbytes
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import EncDecLM, init_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import (ServeSession, ServeSpec, bursty_trace,
                               run_trace, slot_axes, slot_nbytes)
from repro_torch.serve import decode as TD

RTOL = 1e-5
ARCH = "whisper_medium"
F32_EPS = float(np.finfo(np.float32).eps)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1.0), err


def _bf16_step(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_bf16_step(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert np.all(diff <= _bf16_step(want)), (
        int((diff > _bf16_step(want)).sum()), float(diff.max()))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.as_tensor(
        np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)).to(
            torch.bfloat16)


def _models(seed=0, **kw):
    jcfg = jconfigs.get_smoke(ARCH).replace(**kw)
    cfg = configs.get_smoke(ARCH).replace(**kw)
    params = j_init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


@pytest.fixture(scope="module")
def smoke():
    return _models()


def _inputs(cfg, b=2, s=8, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return frames, tokens


# --- weights -----------------------------------------------------------------

def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(getattr(tree, "value", tree))}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def test_params_from_jax_carries_the_encdec_tree(smoke):
    jcfg, cfg, params, model = smoke
    assert isinstance(model, EncDecLM)
    assert len(model.enc_layers) == cfg.enc_layers
    assert len(model.dec_layers) == cfg.n_layers
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))
    assert np.array_equal(model.ln_enc.numpy(),
                          np.asarray(params["ln_enc"].value))
    for stack in ("enc_layers", "dec_layers"):
        want = _flat(params[stack])
        assert {"mlp.wi", "mlp.wo"} <= set(want) and "mlp.wg" not in want
        for li, block in enumerate(getattr(model, stack)):
            got = dict(block.named_parameters())
            assert set(got) == set(want)
            for name, w in got.items():
                assert np.array_equal(w.numpy(), want[name][li]), name


@pytest.mark.parametrize("change", ["enc_missing", "dec_extra", "dec_layers",
                                    "ln_enc"])
def test_params_from_jax_checks_every_name(smoke, change):
    _, cfg, params, _ = smoke
    p = dict(params)
    if change == "enc_missing":
        p["enc_layers"] = {k: v for k, v in params["enc_layers"].items()
                           if k != "ln_mlp"}
    elif change == "dec_extra":
        p["dec_layers"] = dict(params["dec_layers"],
                               ln_extra=params["dec_layers"]["ln_self"])
    elif change == "dec_layers":
        p["dec_layers"] = jax.tree.map(lambda x: x[:1], params["dec_layers"])
    else:
        del p["ln_enc"]
    with pytest.raises((ValueError, KeyError)):
        params_from_jax(p, cfg, device="cpu")


def test_init_model_builds_the_encdec_lm():
    cfg = configs.get_smoke(ARCH)
    a, b = init_model(cfg, seed=3, device="cpu"), \
        init_model(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert not hasattr(a.enc_layers[0].mlp, "wg")
    full, jfull = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    meta = init_model(full, seed=None, device="meta")
    shapes = jax.eval_shape(lambda: j_init_model(jfull, jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in meta.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("s,d", [(16, 128), (65, 128), (2049, 1024)])
def test_sinusoid_within_float32_rounding(s, d):
    """Not bit for bit: XLA's exp / sin / cos and torch's differ by an ulp
    here and there (the JAX package gives other bits under jit than
    eagerly), and an ulp of the frequency is multiplied by the position.
    Each element is within 4 eps (pos + 1) of the reference's (an absolute
    bound: near a zero of sin the relative error is large, so the bf16
    roundings can be steps apart); the bf16 table is the float32 one
    rounded once, as in the reference."""
    want = np.asarray(JT._sinusoid(s, d, jnp.float32))
    got = TT._sinusoid(s, d, torch.float32)
    lim = 4 * F32_EPS * (np.arange(s, dtype=np.float64)[:, None] + 1)
    assert np.all(np.abs(got.numpy().astype(np.float64) - want) <= lim)
    assert torch.equal(TT._sinusoid(s, d, torch.bfloat16),
                       got.to(torch.bfloat16))


def test_gelu_mlp_float32(smoke):
    jcfg, cfg, params, model = smoke
    x = _x((2, 9, cfg.d_model), 1)
    for stack, block in (("enc_layers", model.enc_layers[1]),
                         ("dec_layers", model.dec_layers[0])):
        li = 1 if stack == "enc_layers" else 0
        jp = jax.tree.map(lambda a: a[li], params[stack]["mlp"])
        _close(TL.mlp_apply(block.mlp, torch.as_tensor(x), cfg),
               JL.mlp_apply(jp, jnp.asarray(x), jcfg))


def test_gelu_mlp_bf16_within_one_step():
    jcfg, cfg, params, model = _models(1, dtype="bfloat16",
                                       param_dtype="bfloat16")
    jx, tx = _to_bf16(_x((2, 9, cfg.d_model), 2))
    got = TL.mlp_apply(model.enc_layers[0].mlp, tx, cfg)
    assert got.dtype == torch.bfloat16
    jp = jax.tree.map(lambda a: a[0], params["enc_layers"]["mlp"])
    _within_one_bf16_step(got, JL.mlp_apply(jp, jx, jcfg))


@pytest.mark.parametrize("sq,skv", [(1, 64), (8, 64), (64, 16), (3, 1500)])
@pytest.mark.parametrize("hkv", [4, 1])
def test_cross_attention_plain_kernel_version_matches_chunked(sq, skv, hkv):
    """``ops.flash_attention_op`` on CPU tensors (``mha_ref`` with two
    lengths) against the reference's ``_chunked_attention`` at cross
    shapes (no mask, K/V longer or shorter than Q)."""
    rng = np.random.default_rng(sq * 7 + skv)
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, skv, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, skv, 16)).astype(np.float32)
    got = ops.flash_attention_op(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), causal=False)
    g = 4 // hkv
    want = JL._chunked_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, axis=1),
        jnp.repeat(jnp.asarray(v), g, axis=1), causal=False, window=None,
        chunk=skv)
    _close(got, want)


def test_cross_attention_apply_with_kv_override(smoke):
    jcfg, cfg, params, model = smoke
    x = _x((2, 7, cfg.d_model), 3)
    enc = _x((2, cfg.enc_seq, cfg.d_model), 4)
    attn = model.dec_layers[0].cross_attn
    jp = jax.tree.map(lambda a: a[0], params["dec_layers"]["cross_attn"])
    kx = TL.project_heads(torch.as_tensor(enc), attn.wk, torch.float32)
    vx = TL.project_heads(torch.as_tensor(enc), attn.wv, torch.float32)
    want = JL.attention_apply(
        jp, jnp.asarray(x), jcfg, pos=jnp.zeros((2, 7), jnp.int32),
        causal=False, kv_override=(jnp.asarray(kx.numpy()),
                                   jnp.asarray(vx.numpy())))
    for use_pallas in (False, True):
        got = TL.attention_apply(attn, torch.as_tensor(x),
                                 cfg.replace(use_pallas=use_pallas),
                                 pos=torch.zeros((2, 7), dtype=torch.int64),
                                 causal=False, kv_override=(kx, vx))
        _close(got, want)


def test_cross_attention_bf16_within_one_step():
    jcfg, cfg, params, model = _models(2, dtype="bfloat16",
                                       param_dtype="bfloat16")
    jx, tx = _to_bf16(_x((2, 5, cfg.d_model), 5))
    jk, tk = _to_bf16(_x((2, cfg.n_kv_heads, cfg.enc_seq, cfg.hd), 6))
    jv, tv = _to_bf16(_x((2, cfg.n_kv_heads, cfg.enc_seq, cfg.hd), 7))
    jp = jax.tree.map(lambda a: a[1], params["dec_layers"]["cross_attn"])
    got = TL.attention_apply(model.dec_layers[1].cross_attn, tx, cfg,
                             pos=torch.zeros((2, 5), dtype=torch.int64),
                             causal=False, kv_override=(tk, tv))
    want = JL.attention_apply(jp, jx, jcfg, pos=jnp.zeros((2, 5), jnp.int32),
                              causal=False, kv_override=(jk, jv))
    assert got.dtype == torch.bfloat16
    _within_one_bf16_step(got, want)


# --- the encoder, prefill and decode -------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_encoder_apply(smoke, use_pallas):
    jcfg, cfg, params, model = smoke
    frames, _ = _inputs(cfg)
    got = TT.encoder_apply(model, torch.as_tensor(frames),
                           cfg.replace(use_pallas=use_pallas))
    _close(got, JT.encoder_apply(params, jnp.asarray(frames), jcfg))


def _state_leaves(state):
    c = state.self_kv
    return [("k", c.k), ("v", c.v), ("stored_pos", c.stored_pos),
            ("self_pos", c.pos), ("cross_k", state.cross_k),
            ("cross_v", state.cross_v), ("pos", state.pos)]


def _same_state(got, want):
    for (name, a), (_, b) in zip(_state_leaves(got), _state_leaves(want)):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        if b.dtype.kind == "i":
            assert np.array_equal(a.numpy(), b), name
        else:
            _close(a, b)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_encdec_prefill_and_4_decode_steps(smoke, use_pallas):
    jcfg, cfg, params, model = smoke
    cfg = cfg.replace(use_pallas=use_pallas)
    frames, tokens = _inputs(cfg, s=8, seed=1)
    jl, js = JD.prefill(params, {"frames": jnp.asarray(frames),
                                 "tokens": jnp.asarray(tokens)}, jcfg,
                        max_seq=16)
    tl, ts = TD.prefill(model, {"frames": torch.as_tensor(frames),
                                "tokens": torch.as_tensor(tokens).long()},
                        cfg, max_seq=16)
    assert isinstance(ts, TD.EncDecState)
    _close(tl, jl)
    _same_state(ts, js)
    tok = np.argmax(np.asarray(jl), axis=-1)[:, None]
    for _ in range(4):
        jl, js = JD.decode_step(params, js, jnp.asarray(tok), jcfg)
        tl, ts = TD.decode_step(model, ts, torch.as_tensor(tok).long(), cfg)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
    _same_state(ts, js)


def test_decode_adds_row_0s_position_clamped_to_the_table(smoke):
    """Every row takes the sinusoid of row 0's position, and a position
    past the table's S + 1 rows reads its last row (JAX clamps the index;
    the port clamps explicitly)."""
    jcfg, cfg, params, model = smoke
    frames, tokens = _inputs(cfg, s=6, seed=2)
    S = 12
    tok = np.array([[3], [7]], np.int32)
    logits = {}
    for row0 in (2, S, S + 8):
        _, js = JD.prefill(params, {"frames": jnp.asarray(frames),
                                    "tokens": jnp.asarray(tokens)}, jcfg,
                           max_seq=S)
        _, ts = TD.prefill(model, {"frames": torch.as_tensor(frames),
                                   "tokens": torch.as_tensor(tokens).long()},
                           cfg, max_seq=S)
        pos = np.array([row0, 4], np.int32)
        js = js._replace(pos=jnp.asarray(pos))
        ts.pos.copy_(torch.as_tensor(pos))
        jl, _ = JD.decode_step(params, js, jnp.asarray(tok), jcfg)
        tl, _ = TD.decode_step(model, ts, torch.as_tensor(tok).long(), cfg)
        _close(tl, jl)
        logits[row0] = tl
    assert torch.equal(logits[S], logits[S + 8])        # clamped to row S
    assert not torch.equal(logits[2], logits[S])


def test_decode_state_init_and_reset_match_the_reference(smoke):
    jcfg, cfg, _, _ = smoke
    ts = TD.init_decode_state(cfg, 3, 16, device="cpu")
    js = JD.init_decode_state(jcfg, 3, 16)
    _same_state(ts, js)
    assert slot_axes(cfg) == TD.EncDecState(
        self_kv=TD.KVCache(k=1, v=1, stored_pos=0, pos=0), cross_k=1,
        cross_v=1, pos=0)
    assert j_slot_axes(jcfg).cross_k == 1
    assert slot_nbytes(ts, slot_axes(cfg)) == j_slot_nbytes(
        js, j_slot_axes(jcfg))
    ts.cross_k.fill_(1.0)
    ts.self_kv.pos.fill_(5)
    ts.pos[1] = 9
    TD.reset_slot(ts, 1, cfg, wound_to=16)
    assert float(ts.cross_k[:, 1].abs().max()) == 0.0
    assert float(ts.cross_k[:, 0].min()) == 1.0
    assert int(ts.pos[1]) == int(ts.self_kv.pos[1]) == 15
    with pytest.raises(ValueError, match="prefill='cheap'"):
        TD.init_serve_state(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="prefill='cheap'"):
        JD.init_serve_state(jcfg, 2, 16)


# --- serving -----------------------------------------------------------------

SPEC = dict(slots=8, groups=4, max_seq=64, rebalance_every=4,
            decode="replicated", rebalance="tags")
TRACE = dict(seed=0, prompt_buckets=(4, 8, 16), max_new_cap=12)


def _drive(session, trace, run):
    reqs, submit = [], session.submit
    session.submit = lambda r: (reqs.append(r), submit(r))[1]
    return run(session, trace), reqs


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cheap_session_matches_reference(smoke, use_pallas):
    """The reference serves whisper with 'cheap' prefill only: each slot
    decodes over the zero cross K/V of ``init_decode_state``.  Tokens,
    groups, the rebalance log, prefill_stats, kv_slot_bytes and the
    final state equal the JAX session's; the rows' positions pass the
    sinusoid table, so the clamp runs."""
    jcfg, cfg, params, model = smoke
    cfg = cfg.replace(use_pallas=use_pallas)
    kw = dict(SPEC, prefill="cheap")
    jsess = JSession(params, jcfg, JSpec(**kw))
    jr, jreqs = _drive(jsess, j_bursty_trace(12, vocab=cfg.vocab, **TRACE),
                       j_run_trace)
    sess = ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
    tr, treqs = _drive(sess, bursty_trace(12, vocab=cfg.vocab, **TRACE),
                       run_trace)
    assert tr["completed"] == 12
    assert [r.rid for r in treqs] == [r.rid for r in jreqs]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.group for r in treqs] == [r.group for r in jreqs]
    assert tr["migration_log"] == jr["migration_log"]
    assert len(tr["migration_log"]) >= 2
    assert sess.prefill_stats == jsess.prefill_stats
    assert sess.kv_slot_bytes == jsess.kv_slot_bytes
    _same_state(sess.state, jsess.state)
    assert int(sess.state.pos.max()) > SPEC["max_seq"] + 1


@pytest.mark.parametrize("prefill", ["full", "packed"])
def test_session_refuses_full_and_packed_prefill(smoke, prefill):
    jcfg, cfg, params, model = smoke
    kw = dict(SPEC, prefill=prefill)
    if prefill == "packed":
        kw.update(prefill_capacity=32, page_size=8)
    with pytest.raises(ValueError) as want:
        JSession(params, jcfg, JSpec(**kw))
    with pytest.raises(ValueError) as got:
        ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
    # both packages build the empty serving state before the packed
    # prefill's own check, and refuse it there
    assert "prefill='cheap'" in str(want.value)
    assert "prefill='cheap'" in str(got.value)
