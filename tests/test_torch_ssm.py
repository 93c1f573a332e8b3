"""The SSM family (mamba2) against the JAX package, on the CPU.

The JAX package's SMOKE config is initialised by the JAX package and
carried across with ``interop.params_from_jax``; inputs are drawn with
numpy.  Tolerance in float32: 1e-5 of the largest reference value (sums
taken in another order).  In bf16: one bf16 step per element (both
packages sum in float32 and round once; a sum in another order can move
a rounding by one step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_model as j_init_model
from repro.models import ssm as JS
from repro.serve import decode as JD
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import SSMLM
from repro_torch.serve import decode as TD

RTOL = 1e-5
ARCH = "mamba2_1_3b"


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().float().numpy() if isinstance(
        got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1.0), err


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_bf16_step(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert np.all(diff <= _bf16_step(want)), (
        int((diff > _bf16_step(want)).sum()), float(diff.max()))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def _layer(params, li=0):
    return jax.tree.map(lambda x: x[li], params["layers"])


# --- weights -----------------------------------------------------------------

def test_params_from_jax_copies_every_weight(smoke):
    _, cfg, params, model = smoke
    assert isinstance(model, SSMLM) and len(model.layers) == cfg.n_layers
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))
    for li, block in enumerate(model.layers):
        want = _layer(params, li)
        for name in ("in_proj", "conv_w", "A_log", "D", "dt_bias", "norm_w",
                     "out_proj"):
            assert np.array_equal(getattr(block.mixer, name).numpy(),
                                  np.asarray(want["mixer"][name].value)), name
        assert np.array_equal(block.ln.numpy(), np.asarray(want["ln"].value))


@pytest.mark.parametrize("change", ["missing", "extra", "renamed"])
def test_params_from_jax_checks_every_name(smoke, change):
    _, cfg, params, _ = smoke
    layers = dict(params["layers"])
    mixer = dict(layers["mixer"])
    if change == "missing":
        del mixer["dt_bias"]
    elif change == "extra":
        mixer["bias"] = mixer["D"]
    else:
        mixer["Dskip"] = mixer.pop("D")
    layers["mixer"] = mixer
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(dict(params, layers=layers), cfg, device="cpu")


def test_init_model_fixed_leaves_and_seeding():
    from repro_torch.models import init_model
    cfg = configs.get_smoke(ARCH)
    a = init_model(cfg, seed=3, device="cpu")
    b = init_model(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    jcfg = jconfigs.get_smoke(ARCH)
    want = JS.init_mamba2(jax.random.PRNGKey(0), jcfg)
    mixer = a.layers[0].mixer
    for name in ("conv_b", "D", "dt_bias", "norm_w"):
        assert np.array_equal(getattr(mixer, name).numpy(),
                              np.asarray(want[name].value)), name
    # log(linspace): the two libraries' log may round one ulp apart
    _close(mixer.A_log, want["A_log"].value, 1e-6)
    # the drawn leaves have the reference's scales
    assert abs(float(mixer.in_proj.std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    assert abs(float(mixer.conv_w.std()) / 0.1 - 1) < 0.1


# --- the SSD core ------------------------------------------------------------

def _ssd_inputs(b, s, h, p, ds, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(0, 2, h)).astype(np.float32)
    B = rng.standard_normal((b, s, ds)).astype(np.float32)
    C = rng.standard_normal((b, s, ds)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("s,chunk,with_init", [
    (45, 16, False), (45, 16, True), (64, 16, False), (7, 32, True),
    (1, 8, False)])
def test_ssd_forward(s, chunk, with_init):
    """Lengths that are not a multiple of the chunk pad with dt = 0."""
    b, h, p, ds = 2, 4, 8, 16
    args = _ssd_inputs(b, s, h, p, ds, s + chunk)
    init = _x((b, h, ds, p), 5) if with_init else None
    jy, jf = JS.ssd_forward(*(jnp.asarray(a) for a in args), chunk,
                            init_state=None if init is None
                            else jnp.asarray(init))
    ty, tf = TS.ssd_forward(*(torch.as_tensor(a) for a in args), chunk,
                            init_state=None if init is None
                            else torch.as_tensor(init))
    _close(ty, jy)
    _close(tf, jf)


def test_ssd_forward_pad_adds_nothing():
    """The padded tail adds nothing: a prompt of 45 tokens at chunk 16
    ends in the state of the same prompt at chunk 5 (no padding)."""
    args = [torch.as_tensor(a) for a in _ssd_inputs(1, 45, 2, 4, 8, 3)]
    y16, f16 = TS.ssd_forward(*args, 16)
    y5, f5 = TS.ssd_forward(*args, 5)
    _close(y16, y5.numpy())
    _close(f16, f5.numpy())


def test_segsum_is_a_difference_of_cumsums():
    x = torch.as_tensor(_x((3, 6), 4))
    got = TS._segsum(x)
    want = JS._segsum(jnp.asarray(x.numpy()))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    _close(got.numpy()[fin], np.asarray(want)[fin])


def test_causal_conv():
    x, w, bias = _x((2, 9, 12), 6), _x((12, 4), 7), _x((12,), 8)
    _close(TS.causal_conv(*(torch.as_tensor(a) for a in (x, w, bias))),
           JS._causal_conv(*(jnp.asarray(a) for a in (x, w, bias))))


# --- the block ---------------------------------------------------------------

@pytest.mark.parametrize("s", [45, 32, 3])
def test_mamba2_apply_with_cache(smoke, s):
    jcfg, cfg, params, model = smoke
    x = _x((2, s, cfg.d_model), s)
    jy, jc = JS.mamba2_apply(_layer(params)["mixer"], jnp.asarray(x), jcfg,
                             return_cache=True)
    ty, tc = TS.mamba2_apply(model.layers[0].mixer, torch.as_tensor(x), cfg,
                             return_cache=True)
    _close(ty, jy)
    _close(tc.state, jc.state)
    _close(tc.conv, jc.conv)
    _close(TS.mamba2_apply(model.layers[0].mixer, torch.as_tensor(x), cfg),
           jy)


def test_mamba2_decode(smoke):
    jcfg, cfg, params, model = smoke
    x = _x((2, 20, cfg.d_model), 9)
    jp, tp = _layer(params)["mixer"], model.layers[0].mixer
    _, jc = JS.mamba2_apply(jp, jnp.asarray(x), jcfg, return_cache=True)
    _, tc = TS.mamba2_apply(tp, torch.as_tensor(x), cfg, return_cache=True)
    for t in range(4):
        xt = _x((2, 1, cfg.d_model), 10 + t)
        jy, jc = JS.mamba2_decode(jp, jnp.asarray(xt), jcfg, jc)
        ty, tc = TS.mamba2_decode(tp, torch.as_tensor(xt), cfg, tc)
        _close(ty, jy)
        _close(tc.state, jc.state)
        _close(tc.conv, jc.conv)


def test_init_ssm_cache(smoke):
    jcfg, cfg, _, _ = smoke
    want = JS.init_ssm_cache(jcfg, 3)
    got = TS.init_ssm_cache(cfg, 3, device="cpu")
    for f in ("state", "conv"):
        assert getattr(got, f).shape == getattr(want, f).shape
        assert str(getattr(got, f).dtype).split(".")[-1] == str(
            getattr(want, f).dtype)
    stacked = TS.init_ssm_cache(cfg, 3, device="cpu", n_layers=2)
    assert stacked.state.shape == (2,) + want.state.shape


# --- the whole model: prefill and decode -------------------------------------

@pytest.mark.parametrize("s", [45, 64])
def test_ssm_prefill_and_8_decode_steps(smoke, s):
    jcfg, cfg, params, model = smoke
    tok = np.random.default_rng(s).integers(0, cfg.vocab, (2, s))
    jl, js = JD.prefill(params, {"tokens": jnp.asarray(tok)}, jcfg,
                        max_seq=128)
    tl, ts = TD.prefill(model, {"tokens": torch.as_tensor(tok)}, cfg,
                        max_seq=128)
    assert isinstance(ts, TD.SSMState) and tl.dtype == torch.float32
    _close(tl, jl)
    _close(ts.layers.state, js.layers.state)
    _close(ts.layers.conv, js.layers.conv)
    assert np.array_equal(ts.pos.numpy(), np.asarray(js.pos))
    for t in range(8):
        nxt = np.random.default_rng(100 + t).integers(0, cfg.vocab, (2, 1))
        jl, js = JD.decode_step(params, js, jnp.asarray(nxt), jcfg)
        tl, ts = TD.decode_step(model, ts, torch.as_tensor(nxt), cfg)
        _close(tl, jl)
        _close(ts.layers.state, js.layers.state)
        _close(ts.layers.conv, js.layers.conv)
        assert np.array_equal(ts.pos.numpy(), np.asarray(js.pos))


def test_ssm_states_match_the_reference_layouts(smoke):
    """init_decode_state / init_serve_state / reset_slot against the
    reference's trees: shapes, types, values."""
    jcfg, cfg, _, _ = smoke
    for fn in ("init_decode_state", "init_serve_state"):
        j = getattr(JD, fn)(jcfg, 3, 64)
        t = getattr(TD, fn)(cfg, 3, 64, device="cpu")
        for got, want in ((t.layers.state, j.layers.state),
                          (t.layers.conv, j.layers.conv), (t.pos, j.pos)):
            assert np.array_equal(got.numpy(), np.asarray(want)), fn
            assert str(got.dtype).split(".")[-1] == str(want.dtype), fn
    t = TD.init_serve_state(cfg, 3, 64, device="cpu")
    t.layers.state.normal_()
    t.layers.conv.normal_()
    t.pos.fill_(9)
    for wound in (None, 64):
        TD.reset_slot(t, 1, cfg, wound_to=wound)
        assert not t.layers.state[:, 1].any() and not t.layers.conv[:, 1].any()
        assert int(t.pos[1]) == (0 if wound is None else 63)
        assert t.layers.state[:, 0].any() and int(t.pos[0]) == 9


# --- bf16 --------------------------------------------------------------------

def _bf16_smoke(seed):
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg, cfg = jconfigs.get_smoke(ARCH).replace(**kw), \
        configs.get_smoke(ARCH).replace(**kw)
    params = j_init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def _is_bf16_valued(x: np.ndarray) -> bool:
    return np.array_equal(x, np.asarray(jnp.asarray(x, jnp.bfloat16),
                                        np.float32))


def test_mamba2_apply_bf16_within_one_step():
    """One block on the same bf16 inputs: output and conv tail within one
    bf16 step per element, the float32 state within 1e-5."""
    jcfg, cfg, params, model = _bf16_smoke(2)
    x = jnp.asarray(_x((2, 37, cfg.d_model), 3), jnp.bfloat16)
    jy, jc = JS.mamba2_apply(_layer(params)["mixer"], x, jcfg,
                             return_cache=True)
    ty, tc = TS.mamba2_apply(model.layers[0].mixer, torch.as_tensor(
        np.asarray(x, np.float32)).to(torch.bfloat16), cfg, return_cache=True)
    assert ty.dtype == tc.conv.dtype == torch.bfloat16
    _within_one_bf16_step(ty, jy)
    _within_one_bf16_step(tc.conv, jc.conv)
    _close(tc.state, jc.state)


def test_bf16_conv_window_turns_float32_after_the_first_decode_step():
    """In bf16 the reference's conv window is bf16 after prefill (rounded
    through act_dtype) and float32 after a decode step (its concatenate
    promotes); the port's state takes the same types, and its first
    layer's window (same inputs in both packages) the same values: the
    prefill-seeded entries within one bf16 step, bf16 numbers after the
    promotion too, the decode-produced entries float32 ones."""
    jcfg, cfg, params, model = _bf16_smoke(1)
    tok = np.random.default_rng(7).integers(0, cfg.vocab, (2, 37))
    jl, js = JD.prefill(params, {"tokens": jnp.asarray(tok)}, jcfg,
                        max_seq=64)
    tl, ts = TD.prefill(model, {"tokens": torch.as_tensor(tok)}, cfg,
                        max_seq=64)
    assert js.layers.conv.dtype == jnp.bfloat16
    assert ts.layers.conv.dtype == torch.bfloat16
    _within_one_bf16_step(ts.layers.conv[0], js.layers.conv[0])
    seeded = ts.layers.conv.float().numpy()
    for t in range(4):
        nxt = np.random.default_rng(200 + t).integers(0, cfg.vocab, (2, 1))
        jl, js = JD.decode_step(params, js, jnp.asarray(nxt), jcfg)
        tl, ts = TD.decode_step(model, ts, torch.as_tensor(nxt), cfg)
        assert js.layers.conv.dtype == jnp.float32
        assert ts.layers.conv.dtype == ts.layers.state.dtype == torch.float32
        jconv, tconv = np.asarray(js.layers.conv), ts.layers.conv.numpy()
        # the window shifts by one: the seeded entries move left unchanged
        # (still bf16 values), the new last entry is a float32 value
        kept = max(2 - t, 0)
        assert np.array_equal(tconv[..., :kept], seeded[..., 1 + t:])
        assert _is_bf16_valued(tconv[..., :kept])
        assert _is_bf16_valued(jconv[..., :kept])
        assert not _is_bf16_valued(tconv[..., 2])
        assert not _is_bf16_valued(jconv[..., 2])
        _within_one_bf16_step(torch.as_tensor(tconv[0]),
                              jnp.asarray(jconv[0]))
    assert tl.dtype == torch.float32
    err = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    assert err <= 0.02 * float(np.abs(np.asarray(jl)).max()), err
