"""The hybrid family (recurrentgemma: RG-LRU blocks, local attention,
GeGLU) against the JAX package, on the CPU.

The JAX package's SMOKE config (3 layers: rglru, rglru, attn; window 32)
is initialised by the JAX package and carried across with
``interop.params_from_jax``; inputs are drawn with numpy.  Tolerance in
float32: 1e-5 of the largest reference value (sums in another order).
In bf16: one bf16 step per element on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import init_model as j_init_model
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models.transformer import hybrid_layer_kinds as j_kinds
from repro.serve import decode as JD
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from repro_torch.models.transformer import HybridLM, hybrid_layer_kinds
from repro_torch.serve import decode as TD

RTOL = 1e-5
ARCH = "recurrentgemma_2b"


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().float().numpy() if isinstance(
        got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1.0), err


def _bf16_step(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_bf16_step(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
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


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def _bf16_smoke(seed):
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg, cfg = jconfigs.get_smoke(ARCH).replace(**kw), \
        configs.get_smoke(ARCH).replace(**kw)
    params = j_init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


# --- weights -----------------------------------------------------------------

def test_layer_kinds_and_params_from_jax(smoke):
    jcfg, cfg, params, model = smoke
    kinds = hybrid_layer_kinds(cfg)
    assert kinds == j_kinds(jcfg) == ["rglru", "rglru", "attn"]
    assert hybrid_layer_kinds(configs.get_config(ARCH)) == j_kinds(
        jconfigs.get_config(ARCH))
    assert isinstance(model, HybridLM)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))
    for block, lp, kind in zip(model.layers, params["layers"], kinds):
        assert hasattr(block, kind) and hasattr(block, "mlp")
        part = getattr(block, kind)
        for name, w in lp[kind].items():
            assert np.array_equal(getattr(part, name).numpy(),
                                  np.asarray(w.value)), (kind, name)
        for name, w in lp["mlp"].items():
            assert np.array_equal(getattr(block.mlp, name).numpy(),
                                  np.asarray(w.value)), name


@pytest.mark.parametrize("change", ["missing", "extra", "wrong_kind",
                                    "layers"])
def test_params_from_jax_checks_every_name(smoke, change):
    _, cfg, params, _ = smoke
    layers = [dict(lp) for lp in params["layers"]]
    if change == "missing":
        layers[1]["rglru"] = {k: v for k, v in layers[1]["rglru"].items()
                              if k != "lam"}
    elif change == "extra":
        layers[2]["attn"] = dict(layers[2]["attn"], bias=layers[2]["ln_mix"])
    elif change == "wrong_kind":
        layers[0]["attn"] = layers[2]["attn"]
        del layers[0]["rglru"]
    else:
        layers = layers[:2]
    with pytest.raises(ValueError, match="names differ|layers"):
        params_from_jax(dict(params, layers=layers), cfg, device="cpu")


def test_init_model_fixed_leaves_and_seeding():
    from repro_torch.models import init_model
    cfg = configs.get_smoke(ARCH)
    a = init_model(cfg, seed=3, device="cpu")
    b = init_model(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    want = JR.init_rglru_block(jax.random.PRNGKey(0),
                               jconfigs.get_smoke(ARCH))
    blk = a.layers[0].rglru
    for name in ("conv_b", "b_r", "b_i"):
        assert np.array_equal(getattr(blk, name).numpy(),
                              np.asarray(want[name].value)), name
    # a = sigmoid(lam) is the linspace: the two libraries' linspace and log
    # may round one ulp apart (lam itself, near a = 0.999, magnifies that)
    _close(torch.sigmoid(blk.lam), jax.nn.sigmoid(want["lam"].value), 1e-6)
    assert abs(float(blk.w_r.std()) * np.sqrt(cfg.lru_width) - 1) < 0.05


# --- GeGLU ---------------------------------------------------------------------

def test_geglu_float32(smoke):
    jcfg, cfg, params, model = smoke
    x = _x((2, 9, cfg.d_model), 1)
    _close(TL.mlp_apply(model.layers[0].mlp, torch.as_tensor(x), cfg),
           JL.mlp_apply(params["layers"][0]["mlp"], jnp.asarray(x), jcfg))


def test_geglu_is_the_tanh_gelu():
    x = torch.linspace(-6, 6, 1001)
    _close(TL.gelu(x), jax.nn.gelu(jnp.asarray(x.numpy())), 1e-6)
    erf = torch.nn.functional.gelu(x)
    assert float((erf - TL.gelu(x)).abs().max()) > 1e-4


def test_geglu_bf16_within_one_step():
    jcfg, cfg, params, model = _bf16_smoke(1)
    jx, tx = _to_bf16(_x((2, 9, cfg.d_model), 2))
    got = TL.mlp_apply(model.layers[0].mlp, tx, cfg)
    assert got.dtype == torch.bfloat16
    _within_one_bf16_step(got, JL.mlp_apply(params["layers"][0]["mlp"], jx,
                                            jcfg))


def test_plain_gelu_mlp_is_refused(smoke):
    """Named for the refusal it held while the plain GELU MLP (whisper's)
    was not ported; now the MLP at these widths against the reference's:
    ``wi`` and ``wo`` only, tanh GELU in float32, rounded once."""
    jcfg, cfg, _, _ = smoke
    jcfg, cfg = jcfg.replace(mlp_act="gelu_mlp"), \
        cfg.replace(mlp_act="gelu_mlp")
    jp = JL.init_mlp(jax.random.PRNGKey(4), jcfg)
    assert set(jp) == {"wi", "wo"}
    mlp = TL.MLP(cfg, "cpu")
    assert not hasattr(mlp, "wg")
    with torch.no_grad():
        for name in ("wi", "wo"):
            getattr(mlp, name).copy_(torch.as_tensor(
                np.array(jp[name].value)))
    x = _x((2, 9, cfg.d_model), 5)
    _close(TL.mlp_apply(mlp, torch.as_tensor(x), cfg),
           JL.mlp_apply(jp, jnp.asarray(x), jcfg))


# --- the RG-LRU ----------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 45, 64, 257])
def test_rglru_scan(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (2, s, 16)).astype(np.float32)
    _close(TR.rglru_scan(torch.as_tensor(x), torch.as_tensor(a)),
           JR._rglru_scan(jnp.asarray(x), jnp.asarray(a)))
    h, want = np.zeros((2, 16), np.float32), []
    for t in range(s):                      # the recurrence, step by step
        h = a[:, t] * h + x[:, t]
        want.append(h)
    _close(TR.rglru_scan(torch.as_tensor(x), torch.as_tensor(a)),
           np.stack(want, 1))


@pytest.mark.parametrize("s", [45, 32, 3])
def test_rglru_block_apply_with_cache(smoke, s):
    jcfg, cfg, params, model = smoke
    x = _x((2, s, cfg.d_model), s)
    jy, jc = JR.rglru_block_apply(params["layers"][0]["rglru"],
                                  jnp.asarray(x), jcfg, return_cache=True)
    ty, tc = TR.rglru_block_apply(model.layers[0].rglru, torch.as_tensor(x),
                                  cfg, return_cache=True)
    _close(ty, jy)
    _close(tc.h, jc.h)
    _close(tc.conv, jc.conv)


def test_rglru_block_decode(smoke):
    jcfg, cfg, params, model = smoke
    jp, tp = params["layers"][1]["rglru"], model.layers[1].rglru
    x = _x((2, 20, cfg.d_model), 3)
    _, jc = JR.rglru_block_apply(jp, jnp.asarray(x), jcfg, return_cache=True)
    _, tc = TR.rglru_block_apply(tp, torch.as_tensor(x), cfg,
                                 return_cache=True)
    for t in range(4):
        xt = _x((2, 1, cfg.d_model), 30 + t)
        jy, jc = JR.rglru_block_decode(jp, jnp.asarray(xt), jcfg, jc)
        ty, tc = TR.rglru_block_decode(tp, torch.as_tensor(xt), cfg, tc)
        _close(ty, jy)
        _close(tc.h, jc.h)
        _close(tc.conv, jc.conv)


def test_rglru_block_bf16_within_one_step():
    jcfg, cfg, params, model = _bf16_smoke(2)
    jx, tx = _to_bf16(_x((2, 37, cfg.d_model), 4))
    jy, jc = JR.rglru_block_apply(params["layers"][0]["rglru"], jx, jcfg,
                                  return_cache=True)
    ty, tc = TR.rglru_block_apply(model.layers[0].rglru, tx, cfg,
                                  return_cache=True)
    assert ty.dtype == tc.conv.dtype == torch.bfloat16
    assert tc.h.dtype == torch.float32
    _within_one_bf16_step(ty, jy)
    _within_one_bf16_step(tc.conv, jc.conv)
    _close(tc.h, jc.h)


# --- attention at head dim 256 (the full config's) ---------------------------

@pytest.mark.parametrize("s,window", [(256, 64), (384, None)])
def test_flash_plain_at_head_dim_256_matches_pallas_kernel(s, window):
    """MQA of 10 query heads over 1 kv head at d = 256, as recurrentgemma's
    local attention: the plain version against the Pallas kernel in
    interpret mode."""
    q, k, v = _x((1, 10, s, 256), 5), _x((1, 1, s, 256), 6), \
        _x((1, 1, s, 256), 7)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window,
                                  interpret=True)
    got = ops.flash_attention_op(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), causal=True,
                                 window=window)
    _close(got, want)


# --- the whole model: prefill and decode ---------------------------------------

def _states_close(ts, js):
    assert isinstance(ts, TD.HybridState) and len(ts.layers) == len(js.layers)
    assert np.array_equal(ts.pos.numpy(), np.asarray(js.pos))
    for tc, jc in zip(ts.layers, js.layers):
        if isinstance(tc, TD.KVCache):
            assert isinstance(jc, JD.KVCache)
            _close(tc.k, jc.k)
            _close(tc.v, jc.v)
            assert np.array_equal(tc.stored_pos.numpy(),
                                  np.asarray(jc.stored_pos))
            assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        else:
            _close(tc.h, jc.h)
            _close(tc.conv, jc.conv)


@pytest.mark.parametrize("s,max_seq", [(20, 64), (45, 64), (64, 128),
                                       (20, 24)])
def test_hybrid_prefill_and_8_decode_steps(smoke, s, max_seq):
    """Prompts inside the window (20), wrapping the ring of 32 (45, 64),
    and a ring of 24 (max_seq below the window) that the decode steps
    wrap."""
    jcfg, cfg, params, model = smoke
    tok = np.random.default_rng(s).integers(0, cfg.vocab, (2, s))
    jl, js = JD.prefill(params, {"tokens": jnp.asarray(tok)}, jcfg,
                        max_seq=max_seq)
    tl, ts = TD.prefill(model, {"tokens": torch.as_tensor(tok)}, cfg,
                        max_seq=max_seq)
    assert tl.dtype == torch.float32
    _close(tl, jl)
    _states_close(ts, js)
    for t in range(8):
        nxt = np.random.default_rng(100 + t).integers(0, cfg.vocab, (2, 1))
        jl, js = JD.decode_step(params, js, jnp.asarray(nxt), jcfg)
        tl, ts = TD.decode_step(model, ts, torch.as_tensor(nxt), cfg)
        _close(tl, jl)
        _states_close(ts, js)


def test_hybrid_states_match_the_reference_layouts(smoke):
    """init_decode_state / init_serve_state against the reference's
    trees, and reset_slot against a fresh row of each."""
    jcfg, cfg, _, _ = smoke
    for fn in ("init_decode_state", "init_serve_state"):
        j = getattr(JD, fn)(jcfg, 3, 64)
        t = getattr(TD, fn)(cfg, 3, 64, device="cpu")
        assert np.array_equal(t.pos.numpy(), np.asarray(j.pos)), fn
        for tc, jc in zip(t.layers, j.layers):
            for name in (("k", "v", "stored_pos", "pos")
                         if isinstance(tc, TD.KVCache) else ("h", "conv")):
                got, want = getattr(tc, name), getattr(jc, name)
                assert np.array_equal(got.numpy(), np.asarray(want)), name
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
    for wound, fn in ((None, "init_serve_state"),
                      (64, "init_decode_state")):
        fresh = getattr(TD, fn)(cfg, 3, 64, device="cpu")
        t = TD.init_serve_state(cfg, 3, 64, device="cpu")
        for c in t.layers:
            for name in (("k", "v") if isinstance(c, TD.KVCache)
                         else ("h", "conv")):
                getattr(c, name).normal_()
            if isinstance(c, TD.KVCache):
                c.stored_pos.fill_(7)
                c.pos.fill_(8)
        t.pos.fill_(9)
        TD.reset_slot(t, 1, cfg, wound_to=wound)
        assert int(t.pos[1]) == int(fresh.pos[1]) and int(t.pos[0]) == 9
        for c, f in zip(t.layers, fresh.layers):
            for name in (("k", "v", "stored_pos", "pos")
                         if isinstance(c, TD.KVCache) else ("h", "conv")):
                a, b = getattr(c, name), getattr(f, name)
                row = (slice(None), 1) if name in ("k", "v") else (1,)
                assert torch.equal(a[row], b[row]), name


def test_bf16_rglru_conv_windows_turn_float32_after_a_decode_step():
    """The hybrid's RG-LRU windows are bf16 after prefill and float32 after
    a decode step, in both packages; its attention rings stay bf16; the
    first layer's window (the same inputs in both packages) within one
    bf16 step."""
    jcfg, cfg, params, model = _bf16_smoke(3)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 40))
    jl, js = JD.prefill(params, {"tokens": jnp.asarray(tok)}, jcfg,
                        max_seq=64)
    tl, ts = TD.prefill(model, {"tokens": torch.as_tensor(tok)}, cfg,
                        max_seq=64)

    def types(state):
        """{the RG-LRU windows' type}, checking the rings stay bf16."""
        name = lambda dt: str(dt).split(".")[-1]    # noqa: E731
        for c in state.layers:
            if isinstance(c, (TD.KVCache, JD.KVCache)):
                assert name(c.k.dtype) == "bfloat16"
        return {name(c.conv.dtype) for c in state.layers
                if not isinstance(c, (TD.KVCache, JD.KVCache))}

    assert types(js) == types(ts) == {"bfloat16"}
    _within_one_bf16_step(ts.layers[0].conv, js.layers[0].conv)
    for t in range(3):
        nxt = np.random.default_rng(300 + t).integers(0, cfg.vocab, (2, 1))
        jl, js = JD.decode_step(params, js, jnp.asarray(nxt), jcfg)
        tl, ts = TD.decode_step(model, ts, torch.as_tensor(nxt), cfg)
        assert types(js) == types(ts) == {"float32"}
        _within_one_bf16_step(ts.layers[0].conv, js.layers[0].conv)
    err = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    assert err <= 0.02 * float(np.abs(np.asarray(jl)).max()), err
