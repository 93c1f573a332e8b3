"""The MoE layer and the MoE decoder against the JAX package, on the CPU.

The same numpy inputs and the JAX package's weights (carried across as
their bits) go through ``repro.models.moe`` and ``repro_torch.models.moe``.
Tolerances: integer outputs (slots, keep flags, expert ids, tokens)
equal; float32 within 1e-5 of the largest reference value (sums taken in
another order); bf16 within one bf16 step per element (a float32 sum in
another order can move one rounding by a step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import BalanceSpec as JBalanceSpec
from repro.distributed.sharding import Boxed
from repro.models import dispatch_quality as j_dispatch_quality
from repro.models import dispatch_spec as j_dispatch_spec
from repro.models import init_model as j_init_model
from repro.models import moe as JM
from repro.serve import decode as JD
from repro_torch import configs
from repro_torch.core import BalanceSpec
from repro_torch.interop import params_from_jax
from repro_torch.models import init_model
from repro_torch.models import moe as TM
from repro_torch.serve import decode as TD

RTOL = 1e-5
MOE_ARCHS = ["phi35_moe_42b", "grok_1_314b"]


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1.0), err


def _bits(leaf) -> torch.Tensor:
    """A JAX leaf (``Boxed`` or array) as a CPU tensor of the same bits."""
    a = np.asarray(getattr(leaf, "value", leaf))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _pair(cfg_kw, seed=0, arch="phi35_moe_42b"):
    """(jcfg, cfg, JAX params, port MoE with the same weights)."""
    jcfg = jconfigs.get_smoke(arch).replace(**cfg_kw)
    cfg = configs.get_smoke(arch).replace(**cfg_kw)
    params = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    moe = TM.MoE(cfg, "cpu")
    with torch.no_grad():
        for name in ("router", "wi", "wg", "wo"):
            getattr(moe, name).copy_(_bits(params[name]))
    return jcfg, cfg, params, moe


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


# --- dispatch (Algorithm 1) --------------------------------------------------

@pytest.mark.parametrize("m,e,cap", [
    (100, 8, 16),       # drops
    (64, 4, 64),        # no drops
    (37, 16, 2),        # most experts over capacity
    (1, 8, 1),          # one item
    (256, 2, 100),      # two long runs
])
def test_dispatch_indices_equal_bit_for_bit(m, e, cap):
    idx = np.random.default_rng(m + e).integers(0, e, m).astype(np.int32)
    js, jk = JM._dispatch_indices(jnp.asarray(idx), e, cap)
    ts, tk = TM._dispatch_indices(torch.as_tensor(idx).long(), e, cap)
    assert ts.dtype == torch.int32
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert bool((~tk).any()) == (np.bincount(idx, minlength=e) > cap).any()


def test_dispatch_indices_per_group():
    """Leading dimensions are groups, each dispatched on its own (the
    reference's ``vmap`` over batch rows)."""
    idx = np.random.default_rng(5).integers(0, 8, (3, 40)).astype(np.int32)
    js, jk = jax.vmap(lambda r: JM._dispatch_indices(r, 8, 4))(
        jnp.asarray(idx))
    ts, tk = TM._dispatch_indices(torch.as_tensor(idx).long(), 8, 4)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tk.numpy(), np.asarray(jk))


def test_dispatch_spec_and_quality_equal():
    cfg = configs.get_smoke("phi35_moe_42b")
    jcfg = jconfigs.get_smoke("phi35_moe_42b")
    spec = TM.dispatch_spec(cfg)
    assert spec.to_dict() == j_dispatch_spec(jcfg).to_dict()
    assert BalanceSpec.from_dict(spec.to_dict()) == spec
    assert JBalanceSpec.from_dict(spec.to_dict()) == j_dispatch_spec(jcfg)
    idx = np.random.default_rng(0).integers(0, 8, (2, 64, 2))
    tq = TM.dispatch_quality(torch.as_tensor(idx), 8)
    jq = j_dispatch_quality(jnp.asarray(idx), 8)
    assert np.array_equal(tq.part_weights.numpy(), np.asarray(jq.part_weights))
    assert float(tq.imbalance) == float(jq.imbalance)
    assert float(tq.part_weights.sum()) == 2 * 64 * 2


# --- routing -----------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_reference(arch):
    jcfg, cfg, params, moe = _pair({}, seed=1, arch=arch)
    x = _x((3, 10, cfg.d_model), 2)
    jg, ji, ja = JM._route(params, jnp.asarray(x), jcfg)
    tg, ti, ta = TM._route(moe, torch.as_tensor(x), cfg)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    _close(ta, ja)


def test_route_breaks_ties_to_the_lower_expert():
    """Two equal router columns give every token two equal probabilities;
    ``jax.lax.top_k`` puts the lower expert id first, and so must the
    port (``torch.topk`` promises no order)."""
    jcfg, cfg, params, moe = _pair(dict(n_experts=4, top_k=2), seed=2)
    router = np.asarray(params["router"].value).copy()
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    params = dict(params, router=Boxed(jnp.asarray(router),
                                       params["router"].axes))
    with torch.no_grad():
        moe.router.copy_(torch.as_tensor(router))
    x = _x((2, 12, cfg.d_model), 3)
    jg, ji, ja = JM._route(params, jnp.asarray(x), jcfg)
    tg, ti, ta = TM._route(moe, torch.as_tensor(x), cfg)
    ji = np.asarray(ji)
    # every token's top two are a tied pair, lower id first
    assert np.all(np.isin(ji[..., 0], [0, 1]))
    assert np.array_equal(ji[..., 1], ji[..., 0] + 2)
    assert np.array_equal(ti.numpy(), ji)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    _close(ta, ja)


# --- the layer ---------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_float32(arch, capacity_factor):
    jcfg, cfg, params, moe = _pair(dict(capacity_factor=capacity_factor),
                                   seed=3, arch=arch)
    x = _x((2, 24, cfg.d_model), 4)
    jo, ja = JM.moe_apply(params, jnp.asarray(x), jcfg)
    to, ta = TM.moe_apply(moe, torch.as_tensor(x), cfg)
    assert to.dtype == torch.float32
    _close(to, jo)
    _close(ta, ja)
    if capacity_factor < 1:         # the case drops items
        _, idx, _ = TM._route(moe, torch.as_tensor(x), cfg)
        cap = max(int(capacity_factor * 24 * cfg.top_k / cfg.n_experts), 1)
        _, keep = TM._dispatch_indices(idx.reshape(2, -1), cfg.n_experts, cap)
        assert not bool(keep.all())


class _UpcastEinsum:
    """``jax.numpy`` with an ``einsum`` that upcasts its operands where
    the caller asks for a float32 result.  XLA's CPU runtime has no
    batched BF16 x BF16 = F32 dot ("Unsupported element type for
    DotThunk"), so the reference's bf16 expert einsums cannot run here as
    they are.  bf16 -> float32 is exact, and so is the float32 product of
    two bf16 values, so the upcast einsum computes the product that
    ``preferred_element_type=float32`` asks for, summed in float32 (the
    port's CPU path does the same)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_bf16_within_one_step(arch, monkeypatch):
    """The expert products sum in float32 and round once: h and g stay in
    float32 through the activation (a bf16 batched product would round
    them first, as the port's MLP once did).  The reference runs with
    ``_UpcastEinsum`` in its module."""
    monkeypatch.setattr(JM, "jnp", _UpcastEinsum())
    kw = dict(dtype="bfloat16", param_dtype="bfloat16", capacity_factor=0.5)
    jcfg, cfg, params, moe = _pair(kw, seed=4, arch=arch)
    assert moe.wi.dtype == torch.bfloat16 and moe.router.dtype == torch.float32
    x = jnp.asarray(_x((2, 24, cfg.d_model), 5), jnp.bfloat16)
    jo, ja = JM.moe_apply(params, x, jcfg)
    tx = torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    to, ta = TM.moe_apply(moe, tx, cfg)
    assert to.dtype == torch.bfloat16
    want = np.asarray(jo, np.float32)
    diff = np.abs(to.float().numpy() - want)
    assert np.all(diff <= _bf16_step(want)), (
        int((diff > _bf16_step(want)).sum()), float(diff.max()))
    _close(ta, ja)


@pytest.mark.parametrize("e,ep", [(4, 8), (2, 8)])
def test_dense_expert_weights_read_the_f_slice_layout(e, ep):
    """``ep_shards > n_experts`` stores f-slices (ep, d, f*E/ep): the dense
    path reassembles the logical (E, d, f) / (E, f, d) weights, and
    ``moe_apply`` gives the reference's output from them."""
    kw = dict(n_experts=e, ep_shards=ep, capacity_factor=float(e))
    jcfg, cfg, params, moe = _pair(kw, seed=6)
    assert tuple(moe.wi.shape) == (ep, cfg.d_model, cfg.d_ff * e // ep)
    jw = JM._dense_expert_weights(params, jcfg)
    tw = TM._dense_expert_weights(moe, cfg)
    for t, j in zip(tw, jw):
        assert np.array_equal(t.numpy(), np.asarray(j))
    x = _x((2, 8, cfg.d_model), 7)
    _close(TM.moe_apply(moe, torch.as_tensor(x), cfg)[0],
           JM.moe_apply(params, jnp.asarray(x), jcfg)[0])


def test_moe_init_scale_is_the_references():
    """``wi`` / ``wg`` ~ N(0, 1/d) and ``wo`` ~ N(0, 1/d_ff), as the
    reference's ``init_moe`` draws them (not 1/E, the leading dimension),
    and the router in float32 ~ N(0, 1/d)."""
    cfg = configs.get_smoke("phi35_moe_42b").replace(d_model=256, d_ff=512)
    moe = TM.MoE(cfg, "cpu", torch.Generator().manual_seed(0))
    assert moe.router.dtype == torch.float32
    for name, fan_in in (("router", 256), ("wi", 256), ("wg", 256),
                         ("wo", 512)):
        std = float(getattr(moe, name).double().std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.02, (name, std)
    jp = JM.init_moe(jax.random.PRNGKey(0), jconfigs.get_smoke(
        "phi35_moe_42b").replace(d_model=256, d_ff=512))
    for name in ("router", "wi", "wg", "wo"):
        jstd = float(np.asarray(jp[name].value, np.float64).std())
        tstd = float(getattr(moe, name).double().std())
        assert abs(jstd / tstd - 1.0) < 0.02, name


def test_moe_init_is_seeded():
    cfg = configs.get_smoke("grok_1_314b")
    a = init_model(cfg, seed=3, device="cpu")
    b = init_model(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert [n for n, _ in a.layers[0].named_parameters()] == [
        "ln_attn", "ln_mlp", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
        "moe.router", "moe.wi", "moe.wg", "moe.wo"]


# --- the decoder -------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def smoke(request):
    jcfg = jconfigs.get_smoke(request.param)
    cfg = configs.get_smoke(request.param)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def test_params_from_jax_copies_the_moe_leaves(smoke):
    _, cfg, params, model = smoke
    for li, block in enumerate(model.layers):
        want = jax.tree.map(lambda x: x[li], params["layers"])
        assert not hasattr(block, "mlp")
        for name in ("router", "wi", "wg", "wo"):
            assert np.array_equal(getattr(block.moe, name).numpy(),
                                  np.asarray(want["moe"][name].value))
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.n_params() + cfg.d_model   # the count leaves out ln_f


def test_params_from_jax_checks_names_both_ways(smoke):
    jcfg, cfg, params, _ = smoke
    layers = dict(params["layers"])
    with pytest.raises(ValueError, match="parameter names differ"):
        params_from_jax(dict(params, layers={**layers, "mlp": layers["moe"]}),
                        cfg, device="cpu")
    moe = dict(layers["moe"])
    del moe["router"]
    with pytest.raises(ValueError, match="parameter names differ"):
        params_from_jax(dict(params, layers={**layers, "moe": moe}), cfg,
                        device="cpu")
    with pytest.raises(ValueError, match="parameter names differ"):
        dense = configs.get_smoke("llama3_8b").replace(
            d_model=cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
            n_kv_heads=cfg.n_kv_heads, n_layers=cfg.n_layers, d_ff=cfg.d_ff)
        params_from_jax(params, dense, device="cpu")


def test_decoder_prefill_and_decode(smoke):
    jcfg, cfg, params, model = smoke
    tok = np.random.default_rng(17).integers(0, cfg.vocab, (2, 12))
    jl, jc = JD.decoder_prefill(params, jnp.asarray(tok), jcfg, max_seq=24)
    tl, tc = TD.decoder_prefill(model, torch.as_tensor(tok), cfg, max_seq=24)
    _close(tl, jl)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    nxt = np.random.default_rng(18).integers(0, cfg.vocab, (4, 2, 1))
    for t in range(4):
        jl, jc = JD.decoder_decode_step(params, jc, jnp.asarray(nxt[t]), jcfg)
        tl, tc = TD.decoder_decode_step(model, tc, torch.as_tensor(nxt[t]),
                                        cfg)
        _close(tl, jl)
        _close(tc.k, jc.k)
        assert np.array_equal(tc.stored_pos.numpy(), np.asarray(jc.stored_pos))
        assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_packed_prefill(smoke):
    """One packed buffer is one routing group, pad tokens included."""
    jcfg, cfg, params, model = smoke
    C = 48
    tok = np.random.default_rng(24).integers(0, cfg.vocab, C)
    seg = np.full(C, -1, np.int32)
    pos = np.zeros(C, np.int32)
    last = []
    for sid, (off, ln) in enumerate([(0, 7), (8, 16), (32, 9)]):
        seg[off:off + ln] = sid
        pos[off:off + ln] = np.arange(ln)
        last.append(off + ln - 1)
    last = np.asarray(last, np.int32)
    tok = np.where(seg >= 0, tok, 0)
    jl, jk, jv = JD.packed_prefill(params, *(jnp.asarray(a) for a in
                                             (tok, seg, pos, last)), jcfg)
    tl, tk, tv = TD.packed_prefill(model, *(torch.as_tensor(a) for a in
                                            (tok, seg, pos, last)), cfg)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
