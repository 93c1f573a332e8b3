"""The dense decoder's modules against the JAX package, on the CPU.

The tiny model of the JAX package's serving tests (2 layers, d_model 64,
4 query / 2 kv heads of 16, d_ff 128, float32) is initialised by the JAX
package and carried across with ``interop.params_from_jax``; inputs are
drawn with numpy.  Tolerance: 1e-5 of the largest reference value (float32
rounding of sums taken in another order).  The attention kernels' plain
versions are also held against the Pallas kernels in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import mha_ref as j_mha_ref
from repro.kernels.ref import packed_attention_ref as j_packed_ref
from repro.kernels.serve_prefill import packed_attention_pallas
from repro.models import init_model as j_init_model
from repro.models import layers as JL
from repro.serve import decode as JD
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models.config import ModelConfig
from repro_torch.serve import decode as TD

RTOL = 1e-5
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128)


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1.0), err


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfigs.get_smoke("llama3_8b").replace(**TINY)
    cfg = configs.get_smoke("llama3_8b").replace(**TINY)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def _layer0(params):
    return jax.tree.map(lambda x: x[0], params["layers"])


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --- config and weights ------------------------------------------------------

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


CONFIG_CASES = [pytest.param(which, arch, id=which if arch == "llama3_8b"
                             else f"{which}-{arch}")
                for arch in configs.ARCH_IDS for which in ("CONFIG", "SMOKE")]


@pytest.mark.parametrize("which,arch", CONFIG_CASES)
def test_config_verbatim_with_the_same_size(which, arch):
    get = "get_config" if which == "CONFIG" else "get_smoke"
    j = getattr(jconfigs, get)(arch)
    t = getattr(configs, get)(arch)
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(type(j))]
    assert _fields(t) == _fields(j)
    assert t.hd == j.hd and t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert t.act_dtype == getattr(torch, j.dtype)
    assert t.replace(n_layers=3).n_params() == j.replace(n_layers=3).n_params()
    if which == "CONFIG" and arch == "llama3_8b":
        assert abs(t.n_params() - 8.03e9) < 0.01e9


def test_every_architecture_is_the_references():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10
    for arch in configs.ARCH_IDS:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_smoke, jconfigs.get_smoke)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
                jget(arch)), arch
    with pytest.raises(ValueError, match="one of"):
        configs.get_config("gpt2")


def test_params_from_jax_copies_every_weight(tiny):
    _, cfg, params, model = tiny
    assert np.array_equal(model.embed.tok.numpy(),
                          np.asarray(params["embed"]["tok"].value))
    assert np.array_equal(model.ln_f.numpy(), np.asarray(params["ln_f"].value))
    for li, block in enumerate(model.layers):
        want = jax.tree.map(lambda x: x[li], params["layers"])
        assert np.array_equal(block.attn.wo.numpy(),
                              np.asarray(want["attn"]["wo"].value))
        assert np.array_equal(block.mlp.wg.numpy(),
                              np.asarray(want["mlp"]["wg"].value))
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.n_params() + cfg.d_model   # the count leaves out ln_f


def test_params_from_jax_reads_bfloat16():
    jcfg = jconfigs.get_smoke("llama3_8b").replace(
        **TINY, dtype="bfloat16", param_dtype="bfloat16")
    cfg = configs.get_smoke("llama3_8b").replace(
        **TINY, dtype="bfloat16", param_dtype="bfloat16")
    params = j_init_model(jcfg, jax.random.PRNGKey(1))
    model = params_from_jax(params, cfg, device="cpu")
    assert model.embed.head.dtype == torch.bfloat16
    want = np.asarray(params["embed"]["head"].value.astype(jnp.float32))
    assert np.array_equal(model.embed.head.float().numpy(), want)


def test_lm_logits_casts_a_bfloat16_head_once():
    kw = dict(TINY, dtype="bfloat16", param_dtype="bfloat16")
    jcfg = jconfigs.get_smoke("llama3_8b").replace(**kw)
    cfg = configs.get_smoke("llama3_8b").replace(**kw)
    params = j_init_model(jcfg, jax.random.PRNGKey(2))
    model = params_from_jax(params, cfg, device="cpu")
    x = torch.as_tensor(_x((2, 3, 64), 14)).to(torch.bfloat16)
    got = TL.lm_logits(model.embed, x)
    assert got.dtype == torch.float32
    _close(got, JL.lm_logits(params["embed"], jnp.asarray(
        x.float().numpy()).astype(jnp.bfloat16), jcfg))
    cached = model.embed.head_f32()
    assert cached.dtype == torch.float32
    assert model.embed.head_f32() is cached         # kept between calls
    with torch.no_grad():
        model.embed.head.mul_(2)                    # a write refreshes it
    assert torch.equal(TL.lm_logits(model.embed, x), 2 * got)


def test_init_model_is_seeded_and_refuses_other_families():
    cfg = configs.get_smoke("llama3_8b").replace(**TINY)
    from repro_torch.models import EncDecLM, init_model
    a = init_model(cfg, seed=3, device="cpu")
    b = init_model(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert isinstance(a.layers, torch.nn.ModuleList)
    enc = init_model(cfg.replace(family="encdec", enc_layers=1,
                                 mlp_act="gelu_mlp"), device="cpu")
    assert isinstance(enc, EncDecLM) and len(enc.enc_layers) == 1
    plain = init_model(cfg.replace(mlp_act="gelu_mlp"), device="cpu")
    assert not hasattr(plain.layers[0].mlp, "wg")
    with pytest.raises(ValueError, match="family"):
        init_model(cfg.replace(family="audio"), device="cpu")


# --- layers ------------------------------------------------------------------

def test_rmsnorm_and_rope():
    x, w = _x((2, 5, 64)), _x((64,), 1)
    _close(TL.rmsnorm(torch.as_tensor(x), torch.as_tensor(w)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    q = _x((2, 4, 7, 16), 2)
    pos = np.random.default_rng(3).integers(0, 2048, (2, 7))
    for theta in (10000.0, 500000.0):
        _close(TL.apply_rope(torch.as_tensor(q), torch.as_tensor(pos), theta),
               JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), theta))
    _close(TL.rope_freqs(16, 500000.0), JL.rope_freqs(16, 500000.0))


@pytest.mark.parametrize("variant", ["chunked", "blocked", "flash",
                                     "chunked_window", "blocked_window",
                                     "flash_window"])
def test_attention_apply(tiny, variant):
    jcfg, cfg, params, model = tiny
    kw = dict(attn_chunk=8, causal_blocked_attn=variant.startswith("blocked"),
              use_pallas=variant.startswith("flash"))
    if variant.endswith("window"):
        kw["window"] = 10
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    x = _x((2, 24, 64))
    pos = np.tile(np.arange(24), (2, 1))
    jy, (jk, jv) = JL.attention_apply(
        _layer0(params)["attn"], jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
        causal=True, return_kv=True)
    ty, (tk, tv) = TL.attention_apply(
        model.layers[0].attn, torch.as_tensor(x), cfg,
        pos=torch.as_tensor(pos), causal=True, return_kv=True)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


def test_attention_apply_not_causal(tiny):
    jcfg, cfg, params, model = tiny
    x = _x((1, 16, 64), 4)
    pos = np.arange(16)[None]
    jy = JL.attention_apply(_layer0(params)["attn"], jnp.asarray(x), jcfg,
                            pos=jnp.asarray(pos), causal=False)
    ty = TL.attention_apply(model.layers[0].attn, torch.as_tensor(x), cfg,
                            pos=torch.as_tensor(pos), causal=False)
    _close(ty, jy)


@pytest.mark.parametrize("window", [None, 6])
def test_attention_decode(tiny, window):
    jcfg, cfg, params, model = tiny
    jcfg, cfg = jcfg.replace(window=window), cfg.replace(window=window)
    b, S = 3, 12
    x = _x((b, 1, 64), 6)
    ck, cv = _x((b, 2, S, 16), 7), _x((b, 2, S, 16), 8)
    pos = np.array([0, 5, 11], np.int32)
    stored = np.where(np.arange(S)[None] < pos[:, None], np.arange(S)[None],
                      -1).astype(np.int32)
    stored[1, 2] = -1                                  # a hole
    jy, jk, jv = JL.attention_decode(
        _layer0(params)["attn"], jnp.asarray(x), jcfg, cache_k=jnp.asarray(ck),
        cache_v=jnp.asarray(cv), stored_pos=jnp.asarray(stored),
        pos=jnp.asarray(pos))
    ty, tk, tv = TL.attention_decode(
        model.layers[0].attn, torch.as_tensor(x), cfg,
        cache_k=torch.as_tensor(ck), cache_v=torch.as_tensor(cv),
        stored_pos=torch.as_tensor(stored), pos=torch.as_tensor(pos))
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


def test_mlp_embed_and_head(tiny):
    jcfg, cfg, params, model = tiny
    x = _x((2, 5, 64), 9)
    _close(TL.mlp_apply(model.layers[0].mlp, torch.as_tensor(x), cfg),
           JL.mlp_apply(_layer0(params)["mlp"], jnp.asarray(x), jcfg))
    tok = np.random.default_rng(10).integers(0, cfg.vocab, (2, 5))
    _close(TL.embed_tokens(model.embed, torch.as_tensor(tok), cfg),
           JL.embed_tokens(params["embed"], jnp.asarray(tok), jcfg))
    got = TL.lm_logits(model.embed, torch.as_tensor(x))
    assert got.dtype == torch.float32
    _close(got, JL.lm_logits(params["embed"], jnp.asarray(x), jcfg))


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_mlp_bf16_rounds_once_like_the_reference():
    """In bf16 the reference keeps x·wg and x·wi in float32 until after
    the activation and rounds once before wo.  The same numpy weights and
    inputs through both packages agree within one bf16 step per element
    (float32 sums in another order can move a rounding by one step)."""
    from repro.distributed.sharding import Boxed
    kw = dict(d_model=64, d_ff=256, dtype="bfloat16", param_dtype="bfloat16")
    jcfg = jconfigs.get_smoke("llama3_8b").replace(**kw)
    cfg = configs.get_smoke("llama3_8b").replace(**kw)
    rng = np.random.default_rng(14)
    bf16 = jnp.bfloat16
    w = {name: jnp.asarray(rng.standard_normal(shape) / np.sqrt(shape[0]),
                           bf16)
         for name, shape in (("wi", (64, 256)), ("wg", (64, 256)),
                             ("wo", (256, 64)))}
    x = jnp.asarray(rng.standard_normal((2, 9, 64)), bf16)
    want = np.asarray(JL.mlp_apply({k: Boxed(v, (None, None))
                                    for k, v in w.items()}, x, jcfg),
                      np.float32)
    mlp = TL.MLP(cfg, "cpu")
    with torch.no_grad():
        for name, v in w.items():
            getattr(mlp, name).copy_(torch.as_tensor(np.asarray(v,
                                                                np.float32)))
    tx = torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = TL.mlp_apply(mlp, tx, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= _bf16_step(want)), (
        int((diff > _bf16_step(want)).sum()), float(diff.max()))


# --- attention plain versions against the Pallas kernels ---------------------

@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 4, 2, 128, 16, True, None),
    (2, 2, 1, 256, 32, True, 40),
    (1, 4, 4, 128, 16, False, None),
])
def test_flash_plain_matches_pallas_kernel(b, hq, hkv, s, d, causal, window):
    q, k, v = _x((b, hq, s, d), 11), _x((b, hkv, s, d), 12), _x((b, hkv, s, d),
                                                                13)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, interpret=True)
    got = ops.flash_attention_op(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), causal=causal,
                                 window=window)
    _close(got, want)


@pytest.mark.parametrize("s,window", [(77, None), (33, 9), (1, None)])
def test_flash_plain_any_length(s, window):
    """The TPU kernel needs s % 128 == 0; the plain version (and the CUDA
    kernel) run any s and agree with the reference's plain version."""
    q, k, v = _x((1, 4, s, 16), 14), _x((1, 2, s, 16), 15), _x((1, 2, s, 16),
                                                               16)
    _close(ref.mha_ref(torch.as_tensor(q), torch.as_tensor(k),
                       torch.as_tensor(v), window=window),
           j_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     window=window))


def _random_pack(C, seed):
    """Segment ids of requests packed in order with pad gaps and a pad
    tail, as the engine builds them."""
    rng = np.random.default_rng(seed)
    seg = np.full(C, -1, np.int32)
    off, sid = 0, 0
    while True:
        ln = int(rng.integers(1, 30))
        if off + ln > C - 3:
            break
        seg[off:off + ln] = sid
        off += ln + int(rng.integers(0, 4))
        sid += 1
    return seg


@pytest.mark.parametrize("C,hq,hkv,d,softcap,seed", [
    (100, 4, 2, 16, None, 0),
    (128, 2, 2, 32, 5.0, 1),
    (200, 4, 1, 16, None, 2),
])
def test_packed_plain_matches_pallas_kernel(C, hq, hkv, d, softcap, seed):
    q, k, v = _x((hq, C, d), 20 + seed), _x((hkv, C, d), 30 + seed), \
        _x((hkv, C, d), 40 + seed)
    seg = _random_pack(C, seed)
    want = np.asarray(packed_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        softcap=softcap, interpret=True))
    got = ops.packed_attention_op(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), torch.as_tensor(seg),
                                  softcap=softcap)
    _close(got, want)
    _close(got, j_packed_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(seg), softcap=softcap))
    pad = seg < 0
    assert pad.any()
    assert bool((got[:, torch.as_tensor(pad)] == 0).all())
    assert np.all(want[:, pad] == 0)


# --- prefill and decode of the whole model -----------------------------------

@pytest.mark.parametrize("window,max_seq", [(None, 20), (8, 20)])
def test_decoder_prefill_and_decode(tiny, window, max_seq):
    jcfg, cfg, params, model = tiny
    jcfg, cfg = jcfg.replace(window=window), cfg.replace(window=window)
    tok = np.random.default_rng(17).integers(0, cfg.vocab, (2, 12))
    jl, jc = JD.decoder_prefill(params, jnp.asarray(tok), jcfg,
                                max_seq=max_seq)
    tl, tc = TD.decoder_prefill(model, torch.as_tensor(tok), cfg,
                                max_seq=max_seq)
    assert tl.dtype == torch.float32
    _close(tl, jl)
    for f in ("k", "v"):
        _close(getattr(tc, f), getattr(jc, f))
    for f in ("stored_pos", "pos"):
        assert np.array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    nxt = np.random.default_rng(18).integers(0, cfg.vocab, (4, 2, 1))
    for t in range(4):
        jl, jc = JD.decoder_decode_step(params, jc, jnp.asarray(nxt[t]), jcfg)
        tl, tc = TD.decoder_decode_step(model, tc, torch.as_tensor(nxt[t]), cfg)
        _close(tl, jl)
        _close(tc.k, jc.k)
        assert np.array_equal(tc.stored_pos.numpy(), np.asarray(jc.stored_pos))
        assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_write_slot_at_different_positions():
    """The advanced-index layout of ``_write_slot``: rows at different
    positions, the ring wrapping for one of them."""
    rng = np.random.default_rng(19)
    L, b, hkv, S, hd = 2, 3, 2, 8, 4
    k, v = _x((L, b, hkv, S, hd), 20), _x((L, b, hkv, S, hd), 21)
    sp = rng.integers(-1, 8, (b, S)).astype(np.int32)
    pos = np.array([0, 5, 13], np.int32)
    kn, vn = _x((L, b, hkv, 1, hd), 22), _x((L, b, hkv, 1, hd), 23)
    j = JD._write_slot(JD.KVCache(jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(sp), jnp.asarray(pos)),
                       jnp.asarray(kn), jnp.asarray(vn))
    t = TD._write_slot(TD.KVCache(*(torch.as_tensor(a) for a in (k, v, sp,
                                                                  pos))),
                       torch.as_tensor(kn), torch.as_tensor(vn))
    for f in ("k", "v", "stored_pos", "pos"):
        assert np.array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))


def test_packed_prefill(tiny):
    jcfg, cfg, params, model = tiny
    C = 40
    tok = np.random.default_rng(24).integers(0, cfg.vocab, C)
    seg = np.full(C, -1, np.int32)
    pos = np.zeros(C, np.int32)
    last = []
    for sid, (off, ln) in enumerate([(0, 7), (8, 16), (24, 9)]):
        seg[off:off + ln] = sid
        pos[off:off + ln] = np.arange(ln)
        last.append(off + ln - 1)
    last = np.asarray(last, np.int32)
    tok = np.where(seg >= 0, tok, 0)
    jl, jk, jv = JD.packed_prefill(params, *(jnp.asarray(a) for a in
                                             (tok, seg, pos, last)), jcfg)
    tl, tk, tv = TD.packed_prefill(model, *(torch.as_tensor(a) for a in
                                            (tok, seg, pos, last)), cfg)
    assert tl.dtype == torch.float32
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
