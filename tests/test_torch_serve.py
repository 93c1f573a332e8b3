"""The serving slice as a whole against the JAX package, on the CPU.

``ServeSession`` with replicated decode and tag rebalancing (the
reference's single-device variants) is driven by one seeded bursty trace
in both packages, on the tiny model of the JAX package's serving tests
(weights carried across with ``interop.params_from_jax``).  Output tokens,
``prefill_stats`` and the migration log must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import BalanceSpec as JBalanceSpec
from repro.data.packing import first_fit_pack as j_first_fit_pack
from repro.models import init_model as j_init_model
from repro.serve import ServeSession as JSession
from repro.serve import ServeSpec as JSpec
from repro.serve import bursty_trace as j_bursty_trace
from repro.serve import run_trace as j_run_trace
from repro.serve.slots import make_paged_insert as j_make_paged_insert
from repro.serve.decode import KVCache as JKVCache
from repro_torch import configs
from repro_torch.core import BalanceSpec
from repro_torch.data.packing import first_fit_pack
from repro_torch.interop import params_from_jax
from repro_torch.models import init_model
from repro_torch.serve import (KVCache, Request, ServeSession, ServeSpec,
                               bursty_trace, make_paged_insert,
                               packed_prefill, run_trace)

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128)
SPEC = dict(slots=8, groups=4, max_seq=64, rebalance_every=4,
            decode="replicated", rebalance="tags")
TRACE = dict(seed=0, prompt_buckets=(4, 8, 16), max_new_cap=12)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfigs.get_smoke("llama3_8b").replace(**TINY)
    cfg = configs.get_smoke("llama3_8b").replace(**TINY)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def _spec_kw(prefill):
    kw = dict(SPEC, prefill=prefill)
    if prefill == "packed":
        kw.update(prefill_capacity=32, page_size=8)
    return kw


def _drive(session, trace, run):
    """``run(session, trace)`` with every submitted request recorded."""
    reqs, submit = [], session.submit
    session.submit = lambda r: (reqs.append(r), submit(r))[1]
    return run(session, trace), reqs


# --- host-side pieces --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_bursty_trace_identical(seed):
    kw = dict(seed=seed, vocab=128256, prompt_buckets=(128, 256, 512, 1024),
              max_new_cap=64)
    a, b = j_bursty_trace(32, **kw), bursty_trace(32, **kw)
    assert [(r.rid, r.arrival, r.max_new) for r in a] == [
        (r.rid, r.arrival, r.max_new) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("capacity,align,max_items", [
    (64, 1, None), (64, 8, None), (2048, 16, 16), (40, 8, 3), (7, 1, 2)])
def test_first_fit_pack_identical(capacity, align, max_items):
    lengths = np.random.default_rng(capacity).integers(1, 40, 25)
    want = j_first_fit_pack(lengths, capacity, align=align,
                            max_items=max_items)
    assert first_fit_pack(lengths, capacity, align=align,
                          max_items=max_items) == want


SPECS = [dict(), dict(slots=5, groups=4),
         dict(slots=16, groups=4, max_seq=2048, prefill="packed",
              prefill_capacity=2048, page_size=16, decode="replicated",
              rebalance="tags", rebalance_every=8),
         dict(prefill="packed", max_seq=64), dict(use_pallas=False),
         dict(rebalance="never", prefill="cheap")]


@pytest.mark.parametrize("kw", SPECS, ids=range(len(SPECS)))
def test_serve_spec_dict_equal_across_packages(kw):
    t, j = ServeSpec(**kw), JSpec(**kw)
    assert t.to_dict() == j.to_dict()
    assert ServeSpec.from_dict(j.to_dict()) == t
    assert (t.total_slots, t.slots_per_group, t.prefill_pages) == (
        j.total_slots, j.slots_per_group, j.prefill_pages)
    assert [list(t.usable_slots(g)) for g in range(t.groups)] == [
        list(j.usable_slots(g)) for g in range(j.groups)]


BAD = [dict(slots=0), dict(groups=0), dict(max_seq=1),
       dict(rebalance_every=0), dict(prefill="nope"), dict(decode="nope"),
       dict(rebalance="nope"), dict(page_size=0), dict(prefill_capacity=-1),
       dict(use_pallas="yes"), dict(prefill="packed", max_seq=60),
       dict(prefill="packed", prefill_capacity=12), dict(balance=3),
       dict(groups=4, balance="p2")]


@pytest.mark.parametrize("kw", BAD, ids=range(len(BAD)))
def test_serve_spec_validation_errors_identical(kw):
    if kw.get("balance") == "p2":
        tkw, jkw = dict(kw, balance=BalanceSpec(p=2)), dict(
            kw, balance=JBalanceSpec(p=2))
    else:
        tkw = jkw = kw
    with pytest.raises(ValueError) as te:
        ServeSpec(**tkw)
    with pytest.raises(ValueError) as je:
        JSpec(**jkw)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError):
        ServeSpec.from_dict({**ServeSpec().to_dict(), "bogus": 1})


def test_paged_insert_matches_reference(tiny):
    """Several pages per slot (max_seq > page_size), pad pages (slot -1)
    and one unwritten slot, against the reference's scatter."""
    _, cfg, _, _ = tiny
    L, slots, hkv, S, hd, ps, C = 2, 4, 2, 32, 16, 8, 48
    rng = np.random.default_rng(3)
    k = rng.standard_normal((L, slots, hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((L, slots, hkv, S, hd)).astype(np.float32)
    sp = rng.integers(-1, S, (slots, S)).astype(np.int32)
    pos = rng.integers(0, S, slots).astype(np.int32)
    pk = rng.standard_normal((L, hkv, C, hd)).astype(np.float32)
    pv = rng.standard_normal((L, hkv, C, hd)).astype(np.float32)
    # buffer pages: slot 2 takes 3 pages, slot 0 one, then pad pages
    page_slot = np.array([2, 2, 2, 0, -1, -1], np.int32)
    page_dst = np.array([0, 1, 2, 0, 0, 0], np.int32)
    written = np.array([True, False, True, False])
    slen = np.array([5, 0, 20, 0], np.int32)
    j = j_make_paged_insert(cfg, None, total_slots=slots, page_size=ps,
                            capacity=C)(
        JKVCache(*(jnp.asarray(a) for a in (k, v, sp, pos))),
        *(jnp.asarray(a) for a in (pk, pv, page_slot, page_dst, written,
                                   slen)))
    t = make_paged_insert(cfg, None, total_slots=slots, page_size=ps,
                          capacity=C)(
        KVCache(*(torch.as_tensor(a) for a in (k, v, sp, pos))),
        *(torch.as_tensor(a) for a in (pk, pv, page_slot, page_dst, written,
                                       slen)))
    for f in ("k", "v", "stored_pos", "pos"):
        assert np.array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))


# --- the session -------------------------------------------------------------

@pytest.mark.parametrize("prefill", ["full", "packed", "cheap"])
def test_session_matches_reference(tiny, prefill):
    jcfg, cfg, params, model = tiny
    kw = _spec_kw(prefill)
    jsess = JSession(params, jcfg, JSpec(**kw))
    jr, jreqs = _drive(jsess, j_bursty_trace(24, vocab=cfg.vocab, **TRACE),
                       j_run_trace)
    sess = ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
    tr, treqs = _drive(sess, bursty_trace(24, vocab=cfg.vocab, **TRACE),
                       run_trace)
    assert [r.rid for r in treqs] == [r.rid for r in jreqs]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.group for r in treqs] == [r.group for r in jreqs]
    assert tr["migration_log"] == jr["migration_log"]
    assert len(tr["migration_log"]) >= 5
    for key in ("steps", "tokens", "completed", "prefill_calls", "admitted",
                "prefill_fill_frac", "rebalances"):
        assert tr[key] == jr[key], key
    assert sess.prefill_stats == jsess.prefill_stats
    if prefill == "packed":
        assert sess.prefill_stats["calls"] < len(treqs)
        assert sess.prefill_stats["buffer_tokens"] == 32 * tr["prefill_calls"]
    assert tr["compiles"] == 0 and sess.compile_count() == 0


# --- the other ported architectures at SMOKE ---------------------------------
# (arch, prefill, trace keywords): the MoE family packed against packed and
# full against full (expert capacity couples the requests of one packed
# buffer, so the two prefills give different tokens in the reference
# itself), danube3 with a binding ring (window 32 < prompts of 48-96;
# packed prefill refuses a ring), command-r packed.
ARCH_SPEC = dict(slots=8, groups=4, max_seq=128, rebalance_every=4,
                 decode="replicated", rebalance="tags")
ARCH_TRACE = dict(seed=1, prompt_buckets=(8, 16, 32), max_new_cap=16)
RING_TRACE = dict(seed=1, prompt_buckets=(48, 64, 96), max_new_cap=16)
ARCH_CASES = [("phi35_moe_42b", "packed", ARCH_TRACE),
              ("phi35_moe_42b", "full", ARCH_TRACE),
              ("grok_1_314b", "packed", ARCH_TRACE),
              ("grok_1_314b", "full", ARCH_TRACE),
              ("h2o_danube3_4b", "full", RING_TRACE),
              ("command_r_plus_104b", "packed", ARCH_TRACE)]


@pytest.mark.parametrize("arch,prefill,trace_kw", ARCH_CASES,
                         ids=[f"{a}-{p}" for a, p, _ in ARCH_CASES])
def test_session_matches_reference_at_smoke(arch, prefill, trace_kw):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(params, cfg, device="cpu")
    kw = dict(ARCH_SPEC, prefill=prefill)
    if prefill == "packed":
        kw.update(prefill_capacity=128, page_size=16)
    jsess = JSession(params, jcfg, JSpec(**kw))
    jr, jreqs = _drive(jsess, j_bursty_trace(12, vocab=cfg.vocab,
                                             **trace_kw), j_run_trace)
    sess = ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
    tr, treqs = _drive(sess, bursty_trace(12, vocab=cfg.vocab, **trace_kw),
                       run_trace)
    assert [r.rid for r in treqs] == [r.rid for r in jreqs]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.group for r in treqs] == [r.group for r in jreqs]
    assert tr["migration_log"] == jr["migration_log"]
    assert len(tr["migration_log"]) >= 2
    assert sess.prefill_stats == jsess.prefill_stats
    if cfg.window is not None:      # every prompt wrapped the ring
        assert sess.state.k.shape[3] == cfg.window
        assert min(len(r.prompt) for r in treqs) > cfg.window
        assert np.array_equal(sess.state.stored_pos.numpy(),
                              np.asarray(jsess.state.stored_pos))


def test_packed_and_full_give_the_same_tokens(tiny):
    _, cfg, _, model = tiny
    outs = {}
    for prefill in ("full", "packed"):
        sess = ServeSession(model, cfg, ServeSpec(**_spec_kw(prefill)),
                            device="cpu")
        _, reqs = _drive(sess, bursty_trace(24, vocab=cfg.vocab, **TRACE),
                         run_trace)
        outs[prefill] = [r.out for r in reqs]
    assert outs["full"] == outs["packed"]


@pytest.mark.parametrize("prefill", ["full", "packed"])
def test_on_logits_sees_the_row_of_every_token(tiny, prefill):
    _, cfg, _, model = tiny
    rows, packs = {}, []

    def on_logits(reqs, logits, seg):
        assert logits.dtype == torch.float32
        assert logits.shape == (len(reqs), cfg.vocab)
        if seg is not None:
            packs.append(seg)
        for r, row in zip(reqs, logits):
            rows.setdefault(r.rid, []).append(int(torch.argmax(row)))

    sess = ServeSession(model, cfg, ServeSpec(**_spec_kw(prefill)),
                        device="cpu", on_logits=on_logits)
    _, reqs = _drive(sess, bursty_trace(24, vocab=cfg.vocab, **TRACE),
                     run_trace)
    assert {r.rid: r.out for r in reqs} == rows
    assert len(packs) == (sess.prefill_stats["calls"]
                          if prefill == "packed" else 0)
    assert sum(int((s >= 0).sum()) for s in packs) == (
        sess.prefill_stats["tokens"] if prefill == "packed" else 0)


@pytest.mark.parametrize("prefill", ["cheap", "full", "packed"])
def test_slot_reuse_matches_fresh_session(tiny, prefill):
    """A request admitted into a freed slot decodes as in a fresh session:
    the previous occupant's K/V and positions are reset in place (no
    pristine copy of the state is kept)."""
    _, cfg, _, model = tiny
    rng = np.random.default_rng(0)
    prompt_a = rng.integers(1, cfg.vocab, 8)
    prompt_b = rng.integers(1, cfg.vocab, 8)
    kw = dict(_spec_kw(prefill), slots=1, groups=2, rebalance_every=1000)

    def session():
        return ServeSession(model, cfg, ServeSpec(**kw), device="cpu")

    eng = session()
    a = Request(rid=0, prompt=prompt_a, max_new=6)
    eng.submit(a)
    eng.run(max_steps=16)
    assert a.done
    stale = eng.state.k.abs().sum()
    b = Request(rid=1, prompt=prompt_b, max_new=6)
    eng.submit(b)
    eng.run(max_steps=16)
    assert b.done and stale > 0
    fresh = session()
    b2 = Request(rid=2, prompt=prompt_b, max_new=6)
    fresh.submit(b2)
    fresh.run(max_steps=16)
    assert b.out == b2.out


def test_multi_device_variants_name_the_roadmap(tiny):
    """Sharded decode and KV rebalancing are ported (ROADMAP queue 1, item
    9; tests/test_torch_serve_sharded.py runs them) and refuse to run, as
    the reference's mesh does, without a process group of one rank per
    group: nothing falls back to replicated decode or to tags."""
    _, cfg, _, model = tiny
    with pytest.raises(ValueError, match="process group"):
        ServeSession(model, cfg, ServeSpec(), device="cpu")
    with pytest.raises(ValueError, match="process group"):
        ServeSession(model, cfg, ServeSpec(decode="replicated"),
                     device="cpu")
    with pytest.raises(ValueError, match="process group"):
        ServeSession(model, cfg, ServeSpec(rebalance="tags"), device="cpu")
    with pytest.raises(ValueError, match="interpret"):
        ServeSession(model, cfg, ServeSpec(decode="replicated",
                                           rebalance="tags", interpret=True),
                     device="cpu")


def test_session_rejects_a_model_on_another_device(tiny):
    _, cfg, _, model = tiny
    spec = ServeSpec(**_spec_kw("full"))
    with pytest.raises(ValueError, match="parameters"):
        ServeSession(model, cfg, spec, device="meta")


# --- the recurrent families at SMOKE -----------------------------------------
# mamba2 (O(1) state) and recurrentgemma (RG-LRU state and a local-attention
# ring of 32, which the ring trace's prompts of 48-96 wrap), 'full' and
# 'cheap' prefill (the packed prefill refuses recurrent state in both
# packages).
RECURRENT_CASES = [("mamba2_1_3b", "full", ARCH_TRACE),
                   ("mamba2_1_3b", "cheap", ARCH_TRACE),
                   ("recurrentgemma_2b", "full", RING_TRACE),
                   ("recurrentgemma_2b", "cheap", ARCH_TRACE)]


def _recurrent_leaves(state):
    """(name, array) of every leaf of an SSMState / HybridState of either
    package."""
    if hasattr(state.layers, "state"):                  # SSMState
        return [("state", state.layers.state), ("conv", state.layers.conv),
                ("pos", state.pos)]
    out = [("pos", state.pos)]
    for i, c in enumerate(state.layers):
        names = (("k", "v", "stored_pos", "pos") if hasattr(c, "k")
                 else ("h", "conv"))
        out += [(f"{i}.{n}", getattr(c, n)) for n in names]
    return out


@pytest.mark.parametrize("arch,prefill,trace_kw", RECURRENT_CASES,
                         ids=[f"{a}-{p}" for a, p, _ in RECURRENT_CASES])
def test_recurrent_session_matches_reference(arch, prefill, trace_kw):
    """Tokens, groups, the migration log, prefill_stats, kv_slot_bytes and
    the final state (every leaf, its type too) equal the JAX session's."""
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(params, cfg, device="cpu")
    kw = dict(ARCH_SPEC, prefill=prefill)
    jsess = JSession(params, jcfg, JSpec(**kw))
    jr, jreqs = _drive(jsess, j_bursty_trace(12, vocab=cfg.vocab,
                                             **trace_kw), j_run_trace)
    sess = ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
    tr, treqs = _drive(sess, bursty_trace(12, vocab=cfg.vocab, **trace_kw),
                       run_trace)
    assert [r.rid for r in treqs] == [r.rid for r in jreqs]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.group for r in treqs] == [r.group for r in jreqs]
    assert tr["migration_log"] == jr["migration_log"]
    assert len(tr["migration_log"]) >= 2
    assert sess.prefill_stats == jsess.prefill_stats
    assert sess.kv_slot_bytes == jsess.kv_slot_bytes
    got, want = _recurrent_leaves(sess.state), _recurrent_leaves(jsess.state)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        scale = max(float(np.abs(b).max()), 1.0)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * scale, name
    if arch == "recurrentgemma_2b" and prefill == "full":
        assert min(len(r.prompt) for r in treqs) > cfg.window


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "recurrentgemma_2b"])
def test_packed_prefill_refuses_recurrent_state(arch):
    cfg = configs.get_smoke(arch)
    model = init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="KV-cache family"):
        ServeSession(model, cfg, ServeSpec(**_spec_kw("packed")),
                     device="cpu")
    with pytest.raises(ValueError, match="recurrent state"):
        packed_prefill(model, *(torch.zeros(8, dtype=torch.int64)
                                for _ in range(4)), cfg)


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "recurrentgemma_2b"])
def test_recurrent_slot_reuse_matches_fresh_session(arch):
    """A request admitted into a freed slot decodes as in a fresh session:
    the recurrent state, conv windows and ring are reset in place."""
    cfg = configs.get_smoke(arch)
    model = init_model(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    prompt_a, prompt_b = rng.integers(1, cfg.vocab, 40), \
        rng.integers(1, cfg.vocab, 12)
    kw = dict(_spec_kw("full"), slots=1, groups=2, rebalance_every=1000)
    eng = ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
    eng.submit(Request(rid=0, prompt=prompt_a, max_new=6))
    eng.run(max_steps=16)
    b = Request(rid=1, prompt=prompt_b, max_new=6)
    eng.submit(b)
    eng.run(max_steps=16)
    fresh = ServeSession(model, cfg, ServeSpec(**kw), device="cpu")
    b2 = Request(rid=2, prompt=prompt_b, max_new=6)
    fresh.submit(b2)
    fresh.run(max_steps=16)
    assert b.done and b.out == b2.out
