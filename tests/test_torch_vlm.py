"""The VLM family (qwen2-vl: a GQA decoder with M-RoPE whose stub front
end prepends patch embeddings) against the JAX package, on the CPU.

The JAX package's SMOKE config (2 layers, sections (4, 2, 2)) is
initialised by the JAX package and carried across with
``interop.params_from_jax``; inputs are drawn with numpy.  The reference
runs its plain attention (``use_pallas=False``); the port runs both its
routes (on CPU tensors the flash route is ``kernels.ref.mha_ref``).
Tolerances: M-RoPE and one attention layer within 1e-6 of the largest
reference value, whole forwards within 1e-5.
"""
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
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.models import DecoderLM, decoder_hidden
from repro_torch.models import layers as TL
from repro_torch.serve import (KVCache, ServeSession, ServeSpec,
                               bursty_trace, run_trace)
from repro_torch.serve import decode as TD

ARCH = "qwen2_vl_72b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1.0), err


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pos3(b, s, seed):
    """Distinct (t, h, w) streams: a text run, then a 4 x 4 patch grid at
    one time step, then text again, as a VLM's front end lays them out."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 3 * s, (b, s)), axis=1)
    h = rng.integers(0, 4, (b, s))
    w = rng.integers(0, 4, (b, s))
    return np.stack([t, t + h, t + w]).astype(np.int32)


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def test_params_from_jax_and_config(smoke):
    jcfg, cfg, params, model = smoke
    assert isinstance(model, DecoderLM) and cfg.family == "vlm"
    assert cfg.mrope_sections == jcfg.mrope_sections == (4, 2, 2)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))
    assert np.array_equal(model.layers[1].attn.wq.numpy(),
                          np.asarray(params["layers"]["attn"]["wq"].value[1]))
    full = configs.get_config(ARCH)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.hd, full.d_ff,
            full.vocab, full.mrope_sections) == (
        8192, 64, 8, 128, 29568, 152064, (16, 24, 24))


# --- M-RoPE ------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections,theta", [
    (16, (4, 2, 2), 10000.0), (128, (16, 24, 24), 1000000.0)])
def test_apply_mrope_with_distinct_streams(hd, sections, theta):
    x = _x((2, 3, 11, hd), 1)
    pos3 = _pos3(2, 11, 2)
    got = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), theta,
                         sections)
    _close(got, JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                               sections), 1e-6)


def test_apply_mrope_with_one_stream_is_rope():
    """Serving builds pos3 as the same arange in all three streams, which
    gives RoPE's angles: the same bits."""
    x = torch.as_tensor(_x((2, 4, 9, 16), 3))
    pos = torch.arange(9)[None].expand(2, 9)
    assert torch.equal(TL.apply_mrope(x, pos[None].expand(3, 2, 9), 1e4,
                                      (4, 2, 2)),
                       TL.apply_rope(x, pos, 1e4))
    with pytest.raises(ValueError, match="sections"):
        TL.apply_mrope(x, pos[None].expand(3, 2, 9), 1e4, (4, 2, 1))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_apply_with_pos3(smoke, use_pallas):
    jcfg, cfg, params, model = smoke
    x = _x((2, 13, cfg.d_model), 4)
    pos3 = _pos3(2, 13, 5)
    pos = np.broadcast_to(np.arange(13), (2, 13)).copy()
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    want, (jk, jv) = JL.attention_apply(
        jp, jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
        pos3=jnp.asarray(pos3), return_kv=True)
    got, (k, v) = TL.attention_apply(
        model.layers[0].attn, torch.as_tensor(x),
        cfg.replace(use_pallas=use_pallas), pos=torch.as_tensor(pos),
        pos3=torch.as_tensor(pos3), return_kv=True)
    _close(got, want, 1e-6)
    _close(k, jk, 1e-6)
    _close(v, jv, 1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decoder_hidden_with_patches_and_distinct_streams(smoke, use_pallas):
    jcfg, cfg, params, model = smoke
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    patches = _x((2, cfg.vision_patches, cfg.d_model), 7)
    pos3 = _pos3(2, cfg.vision_patches + 9, 8)
    want, _ = JT.decoder_hidden(params, jnp.asarray(tokens), jcfg,
                                pos3=jnp.asarray(pos3),
                                patch_embeds=jnp.asarray(patches))
    got = decoder_hidden(model, torch.as_tensor(tokens).long(),
                         cfg.replace(use_pallas=use_pallas),
                         pos3=torch.as_tensor(pos3),
                         patch_embeds=torch.as_tensor(patches))
    _close(got, want, 1e-5)


# --- serving -----------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_with_patch_embeds_and_decode(smoke, use_pallas):
    """The batch API with the stub front end: patch embeddings before the
    prompt (pos3 as the reference builds it), then 4 decode steps; logits
    and the cache against the reference's."""
    jcfg, cfg, params, model = smoke
    cfg = cfg.replace(use_pallas=use_pallas)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    patches = _x((2, cfg.vision_patches, cfg.d_model), 10)
    jl, js = JD.prefill(params, {"tokens": jnp.asarray(tokens),
                                 "patch_embeds": jnp.asarray(patches)},
                        jcfg, max_seq=64)
    tl, ts = TD.prefill(model, {"tokens": torch.as_tensor(tokens).long(),
                                "patch_embeds": torch.as_tensor(patches)},
                        cfg, max_seq=64)
    assert isinstance(ts, KVCache)
    assert int(ts.pos[0]) == cfg.vision_patches + 12
    _close(tl, jl, 1e-5)
    tok = np.argmax(np.asarray(jl), axis=-1)[:, None]
    for _ in range(4):
        jl, js = JD.decode_step(params, js, jnp.asarray(tok), jcfg)
        tl, ts = TD.decode_step(model, ts, torch.as_tensor(tok).long(), cfg)
        _close(tl, jl, 1e-5)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
    _close(ts.k, js.k, 1e-5)
    assert np.array_equal(ts.stored_pos.numpy(), np.asarray(js.stored_pos))
    assert np.array_equal(ts.pos.numpy(), np.asarray(js.pos))


SPEC = dict(slots=8, groups=4, max_seq=128, rebalance_every=4,
            decode="replicated", rebalance="tags")
TRACE = dict(seed=1, prompt_buckets=(8, 16, 32), max_new_cap=16)


def _drive(session, trace, run):
    reqs, submit = [], session.submit
    session.submit = lambda r: (reqs.append(r), submit(r))[1]
    return run(session, trace), reqs


@pytest.mark.parametrize("use_pallas", [False, True])
def test_full_session_matches_reference(smoke, use_pallas):
    """A 'full' prefill session (M-RoPE prefill, RoPE decode): tokens,
    groups, the rebalance log and prefill_stats equal the JAX session's."""
    jcfg, cfg, params, model = smoke
    cfg = cfg.replace(use_pallas=use_pallas)
    kw = dict(SPEC, prefill="full")
    jsess = JSession(params, jcfg, JSpec(**kw))
    jr, jreqs = _drive(jsess, j_bursty_trace(12, vocab=cfg.vocab, **TRACE),
                       j_run_trace)
    sess = ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
    tr, treqs = _drive(sess, bursty_trace(12, vocab=cfg.vocab, **TRACE),
                       run_trace)
    assert tr["completed"] == 12
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.group for r in treqs] == [r.group for r in jreqs]
    assert tr["migration_log"] == jr["migration_log"]
    assert len(tr["migration_log"]) >= 2
    assert sess.prefill_stats == jsess.prefill_stats
    assert sess.kv_slot_bytes == jsess.kv_slot_bytes


def test_packed_prefill_is_refused_for_mrope(smoke):
    jcfg, cfg, params, model = smoke
    kw = dict(SPEC, prefill="packed", prefill_capacity=64, page_size=8)
    with pytest.raises(ValueError, match="mrope"):
        JSession(params, jcfg, JSpec(**kw))
    with pytest.raises(ValueError, match="mrope"):
        ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
