"""Sharded serving with KV-slot migration against the JAX package, on the
CPU.

The port's ``ServeSession(..., ServeSpec(decode="sharded",
rebalance="kv"), comm=...)`` runs on gloo worlds of 4 and 2 CPU ranks
(one per request group; rank bodies in ``_torch_world.py``); the JAX
package's session runs the same scenarios on the suite's host devices.
The scenarios are those of the JAX package's sharded-serving tests
(``tests/test_serve.py``), on its tiny model, with the weights carried
across by ``interop.params_from_jax``.  Tokens, groups, slots, the
migration log and ``prefill_stats`` must be equal, and equal on every
rank.  ``test_serve.py``'s ``p = 8`` packed case runs at ``p = 4``
here, the largest world of the file.  One world of each size serves the
whole file (module fixture).
"""
import concurrent.futures
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import init_model as j_init_model
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JSession
from repro.serve import ServeSpec as JSpec
from repro.serve import decode as JD
from repro.serve.decode import KVCache as JKVCache
from repro.serve.slots import SlotMigrator as JSlotMigrator
from repro.serve.slots import build_serve_mesh, slot_axes as j_slot_axes
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.models import init_model
from repro_torch.serve import Request, ServeSession, ServeSpec

import _torch_world as W

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128)
# global slot moves of the migrator case: a chain (0 -> 6 vacates 6 for
# 6 -> 3) and two more, at most spg = 2 arrivals a group
MOVES = [(0, 6), (6, 3), (5, 1), (4, 7)]


def _prompts(vocab):
    rng = np.random.default_rng(17)
    draw = lambda s: rng.integers(1, vocab, s)         # noqa: E731
    return {"parity": draw(8), "pair": (draw(8), draw(8)),
            "kv": [draw(8) for _ in range(10)],
            "packed": [draw(s) for s in (3, 5, 7, 9, 11, 6, 13, 4, 8, 10)],
            "multi": [draw(s) for s in (7, 6, 5, 8, 3, 4)]}


def _migration_case(cfg):
    rng = np.random.default_rng(5)
    L, slots, hkv, S, hd = cfg.n_layers, 8, cfg.n_kv_heads, 64, cfg.hd
    arrays = (rng.standard_normal((L, slots, hkv, S, hd)).astype(np.float32),
              rng.standard_normal((L, slots, hkv, S, hd)).astype(np.float32),
              rng.integers(-1, S, (slots, S)).astype(np.int32),
              rng.integers(0, S, slots).astype(np.int32))
    # 1 byte: every chunk holds one layer
    return arrays, MOVES, 1


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfigs.get_smoke("llama3_8b").replace(**TINY)
    cfg = configs.get_smoke("llama3_8b").replace(**TINY)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(params, cfg, device="cpu")
    weights = {k: v.numpy() for k, v in model.state_dict().items()}
    return jcfg, cfg, params, model, weights


@pytest.fixture(scope="module")
def moe_case():
    """phi3.5-moe SMOKE, seeded port weights, ten prompts of 5-12 tokens."""
    cfg = configs.get_smoke("phi35_moe_42b")
    model = init_model(cfg, seed=0, device="cpu")
    weights = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab, 5 + i % 8) for i in range(10)]
    return cfg, weights, prompts, model


RECURRENT = ("mamba2_1_3b", "recurrentgemma_2b")
# moves of the recurrent migrator case: a chain and two more
RECURRENT_MOVES = [(1, 6), (6, 2), (4, 0), (7, 5)]


# the encoder-decoder and the VLM, served sharded like the recurrent ones
FAMILIES = ("whisper_medium", "qwen2_vl_72b")


def _family_cases(archs, seed):
    """Per architecture: the JAX SMOKE params and config, the port
    weights, the prompts, a random global state of 8 slots (its leaves)
    for the migrator, shaped like the family's serving state (the
    encoder-decoder's dry-run state: it has no empty one)."""
    out = {}
    for i, arch in enumerate(archs):
        jcfg = jconfigs.get_smoke(arch)
        params = j_init_model(jcfg, jax.random.PRNGKey(0))
        model = params_from_jax(params, configs.get_smoke(arch),
                                device="cpu")
        weights = {k: v.numpy() for k, v in model.state_dict().items()}
        rng = np.random.default_rng(seed + i)
        init = (JD.init_decode_state if jcfg.family == "encdec"
                else JD.init_serve_state)
        template = init(jcfg, 8, 64)
        arrays = [rng.integers(-1, 64, x.shape).astype(np.int32)
                  if x.dtype == jnp.int32 else
                  rng.standard_normal(x.shape).astype(np.float32)
                  for x in jax.tree.leaves(template)]
        out[arch] = dict(jcfg=jcfg, params=params, weights=weights,
                         prompts=W.recurrent_prompts(jcfg.vocab,
                                                     seed + 10 + i),
                         arrays=arrays, template=template)
    return out


@pytest.fixture(scope="module")
def recurrent():
    return _family_cases(RECURRENT, 30)


@pytest.fixture(scope="module")
def families():
    return _family_cases(FAMILIES, 60)


def _port_worlds(cfg, weights, moe_case, recurrent, families,
                 tmp_path_factory):
    """{groups: [rank 0's results, rank 1's, ...]} from one world each."""
    prompts = _prompts(cfg.vocab)

    def case(r, *arch):
        return (*arch, r["weights"], r["prompts"], r["arrays"],
                RECURRENT_MOVES)

    rec = [case(r, arch) for arch, r in recurrent.items()]
    fam = {a: case(families[a]) for a in FAMILIES}
    return {p: W.world(W.serve_world, cfg, weights, prompts,
                       _migration_case(cfg) if p == 4 else None,
                       moe_case[:3] if p == 4 else None,
                       rec if p == 4 else (),
                       fam["whisper_medium"] if p == 4 else None,
                       fam["qwen2_vl_72b"] if p == 4 else None,
                       tmp_path=tmp_path_factory.mktemp(f"serve{p}"), p=p)
            for p in (4, 2)}


def _j_recurrent(r, arch=None):
    """The JAX package's scenarios and migrator of a recurrent, encdec or
    VLM case on 4 groups, under the case's spec."""
    jcfg, params = r["jcfg"], r["params"]
    base = W.FAMILY_SPEC.get(arch, W.RECURRENT_SPEC)

    def make(**kw):
        return JSession(params, jcfg, JSpec(**{**base, **kw}))

    state = jax.tree.unflatten(jax.tree.structure(r["template"]),
                               [jnp.asarray(a) for a in r["arrays"]])
    mig = JSlotMigrator(jcfg, build_serve_mesh(4), j_slot_axes(jcfg), state)
    state, stats = mig(state, RECURRENT_MOVES)
    return {"scenarios": W.recurrent_scenarios(make, JRequest, r["prompts"]),
            "migration": ([np.asarray(x) for x in jax.tree.leaves(state)],
                          stats, mig.bytes_per_slot)}


@pytest.fixture(scope="module")
def runs(tiny, moe_case, recurrent, families, tmp_path_factory):
    """The port's worlds (in a thread: the ranks are processes) while the
    JAX package runs the same scenarios here."""
    jcfg, cfg, params, _, weights = tiny
    prompts = _prompts(cfg.vocab)

    def make(**kw):
        return JSession(params, jcfg, JSpec(**{**W.SERVE_BASE, **kw}))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        worlds = pool.submit(_port_worlds, cfg, weights, moe_case, recurrent,
                             families, tmp_path_factory)
        reference = {p: W.serve_scenarios(make, JRequest, prompts, p)
                     for p in (4, 2)}
        reference["recurrent"] = {arch: _j_recurrent(r)
                                  for arch, r in recurrent.items()}
        reference["families"] = {arch: _j_recurrent(r, arch)
                                 for arch, r in families.items()}
        return worlds.result(), reference


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


def _plain(x):
    """Results with NaN made comparable (a forced move logs imbalance
    NaN) and tuples as lists."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


SCENARIOS = [(4, "migration_parity"), (4, "kv_rebalance"),
             (4, "packed_parity"), (4, "multi_pack"), (2, "slot_reuse"),
             (2, "packed_parity"), (2, "deferred")]


@pytest.mark.parametrize("p,name", SCENARIOS,
                         ids=[f"{n}-p{p}" for p, n in SCENARIOS])
def test_sharded_session_matches_reference(port, reference, p, name):
    """Tokens, groups, slots, migration log (moved_kv_bytes, deferred,
    deferred_retries), prefill_stats and forced-move stats equal the JAX
    session's, on every rank."""
    want = _plain(reference[p][name])
    for rank, res in enumerate(port[p]):
        assert _plain(res["scenarios"][name]) == want, rank


@pytest.mark.parametrize("p", [4, 2])
def test_every_rank_agrees(port, p):
    first = _plain(port[p][0]["scenarios"])
    for res in port[p][1:]:
        assert _plain(res["scenarios"]) == first


def test_forced_migration_changes_no_token(port):
    res = port[4][0]["scenarios"]["migration_parity"]
    ref, mig = res["ref"], res["mig"]
    assert ref["done"] == mig["done"] == [True]
    assert mig["migrations"] == [1] and mig["group"] == [2]
    assert ref["out"] == mig["out"]
    assert mig["stats"]["moved_kv_bytes"] == mig["kv_slot_bytes"]
    assert mig["stats"]["moved_bytes"] == mig["kv_slot_bytes"]
    assert mig["stats"]["n_moved"] == 1 and mig["stats"]["overflow"] == 0
    forced = mig["log"][-1]
    assert forced["forced"] and forced["n_moved"] == 1


def test_kv_rebalance_logs_moved_bytes(port):
    res = port[4][0]["scenarios"]["kv_rebalance"]
    assert all(res["done"]) and len(res["log"]) >= 1
    for e in res["log"]:
        assert 0 <= e["deferred_retries"] <= e["n_moved"]
        assert e["moved_kv_bytes"] == e["n_moved"] * res["kv_slot_bytes"]
    moved = sum(e["moved_kv_bytes"] for e in res["log"])
    assert sum(res["migrations"]) >= 1
    assert moved == sum(res["migrations"]) * res["kv_slot_bytes"]


@pytest.mark.parametrize("p", [4, 2])
def test_packed_and_full_give_the_same_tokens(port, p):
    res = port[p][0]["scenarios"]["packed_parity"]
    assert all(res["full"]["done"]) and all(res["packed"]["done"])
    assert res["packed"]["out"] == res["full"]["out"]
    st = res["packed"]["prefill_stats"]
    assert st["requests"] == 10 and st["calls"] < 10
    assert st["buffer_tokens"] == st["calls"] * 32


def test_a_small_buffer_packs_several_times(port):
    multi = port[4][0]["scenarios"]["multi_pack"]
    assert all(multi["packed"]["done"])
    assert multi["packed"]["out"] == multi["full"]["out"]
    assert multi["packed"]["prefill_stats"]["calls"] >= 3


def test_both_ends_of_a_migration_are_reusable(port):
    res = port[2][0]["scenarios"]["slot_reuse"]
    assert res["seated"] == 0 and res["moved_to"] == (1, 1)
    assert all(res["ab"]["done"]) and res["ab"]["migrations"][1] == 0
    assert res["ab"]["out"][1] == res["fresh_b"]["out"][0]
    assert all(res["cd"]["done"]) and set(res["cd"]["group"]) == {0, 1}
    assert res["cd"]["out"] == [res["fresh_b"]["out"][0],
                                res["fresh_a"]["out"][0]]


def test_deferred_move_is_retried_first(port):
    res = port[2][0]["scenarios"]["deferred"]
    lo_rid, lo_slot = res["lo"]
    assert sorted(res["groups"]) == [0, 1]
    assert res["first"] == ([], {lo_rid: 1}, 0)
    assert res["kept"] == {lo_rid: 1}
    assert res["second"] == ([(lo_slot, res["hi_slot"])], {}, 1)
    assert res["kept_after"] == {}


def test_moe_sharded_decode_equals_replicated(port, moe_case):
    """An MoE model served with sharded decode (each rank decodes its own
    rows; a decode row is its own routing group, s = 1) and KV
    rebalancing gives the replicated session's tokens, on every rank,
    while its rebalances migrate KV slots.  (Groups may differ from the
    replicated session's tags: a KV move into a full group is deferred.)"""
    cfg, _, prompts, model = moe_case
    spec = dict(W.MOE_SPEC, decode="replicated", rebalance="tags")
    sess = ServeSession(model, cfg, ServeSpec(**spec), device="cpu")
    want = W._run_all(sess, W.moe_requests(Request, prompts), 128)
    assert all(want["done"])
    first = port[4][0]["moe"]
    assert all(first["done"]) and first["out"] == want["out"]
    for res in port[4][1:]:
        assert res["moe"] == first
    assert sum(first["migrations"]) >= 1


def _j_migrate(tiny, arrays, moves):
    jcfg = tiny[0]
    state = JKVCache(*(jnp.asarray(a) for a in arrays))
    mig = JSlotMigrator(jcfg, build_serve_mesh(4), j_slot_axes(jcfg), state)
    state, stats = mig(state, moves)
    return [np.asarray(x) for x in (state.k, state.v, state.stored_pos,
                                    state.pos)], stats


def test_slot_migrator_matches_reference_whole_and_chunked(tiny, port):
    """The ranks' rows after the migration, in rank order, equal the JAX
    migrator's global state; shipping one layer a chunk gives the bits of
    one whole call, and the same psummed stats."""
    arrays, moves, _ = _migration_case(tiny[1])
    want, jstats = _j_migrate(tiny, arrays, moves)
    ranks = [r["migration"] for r in port[4]]
    for name in ("whole", "chunked"):
        got = [np.concatenate([r[name]["state"][0] for r in ranks], axis=1),
               np.concatenate([r[name]["state"][1] for r in ranks], axis=1),
               np.concatenate([r[name]["state"][2] for r in ranks]),
               np.concatenate([r[name]["state"][3] for r in ranks])]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for r in ranks:
            assert r[name]["stats"] == jstats
    nbytes = sum(a[:, 0].nbytes if a.ndim == 5 else a[0].nbytes
                 for a in arrays)
    assert jstats["moved_bytes"] == len(moves) * nbytes
    # counted at the exchange: the fixed capacity ships 4 ranks x 2 rows
    # a call; chunked, the weight and validity rows (4 B each) go once a
    # chunk (2 layers: 2 chunks)
    assert ranks[0]["whole"]["wire_bytes"] == 8 * (nbytes + 8)
    assert ranks[0]["chunked"]["wire_bytes"] == 8 * (nbytes + 16)



# --- the recurrent families ----------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("name", ["migration_parity", "kv_rebalance"])
def test_recurrent_sharded_session_matches_reference(port, reference, arch,
                                                     name):
    """mamba2 and recurrentgemma with sharded decode and KV rebalancing:
    tokens, groups, slots, the migration log (moved_kv_bytes in the
    reference's count) and prefill_stats equal the JAX session's on every
    rank."""
    want = _plain(reference["recurrent"][arch]["scenarios"][name])
    for rank, res in enumerate(port[4]):
        assert _plain(res["recurrent"][arch]["scenarios"][name]) == want, rank


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forced_migration_changes_no_token(port, arch):
    res = port[4][0]["recurrent"][arch]["scenarios"]
    ref, mig = res["migration_parity"]["ref"], res["migration_parity"]["mig"]
    assert ref["done"] == mig["done"] == [True]
    assert mig["migrations"] == [1] and mig["group"] == [2]
    assert ref["out"] == mig["out"]
    assert mig["stats"]["moved_kv_bytes"] == mig["kv_slot_bytes"]
    kv = res["kv_rebalance"]
    assert sum(kv["migrations"]) >= 1
    assert sum(e["moved_kv_bytes"] for e in kv["log"]) == (
        sum(kv["migrations"]) * kv["kv_slot_bytes"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_slot_migrator_matches_reference(port, reference,
                                                   recurrent, arch):
    """The SSM state (stacked layers) and the hybrid's per-layer tuple of
    rings and RG-LRU states, shipped whole and one layer a chunk: the
    ranks' rows in rank order equal the JAX migrator's global state, with
    the same stats."""
    from repro_torch.serve import slot_axes
    from repro_torch.serve.slots import _leaves
    want, jstats, jbytes = reference["recurrent"][arch]["migration"]
    axes = _leaves(slot_axes(configs.get_smoke(arch)))
    ranks = [r["recurrent"][arch]["migration"] for r in port[4]]
    for name in ("whole", "chunked"):
        got = [np.concatenate([r[name]["state"][i] for r in ranks], axis=ax)
               for i, ax in enumerate(axes)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for r in ranks:
            assert r[name]["stats"] == jstats
    assert jstats["moved_bytes"] == len(RECURRENT_MOVES) * jbytes
    # one layer a chunk: the weight and validity rows go once a chunk
    n_layers = configs.get_smoke(arch).n_layers
    whole, chunked = ranks[0]["whole"], ranks[0]["chunked"]
    assert chunked["wire_bytes"] - whole["wire_bytes"] == (
        8 * 8 * (n_layers - 1))


# --- the encoder-decoder and the VLM -------------------------------------------

_FAMILY_KEY = {"whisper_medium": "encdec", "qwen2_vl_72b": "vlm"}


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("name", ["migration_parity", "kv_rebalance"])
def test_family_sharded_session_matches_reference(port, reference, arch,
                                                  name):
    """whisper (cheap prefill, zero cross K/V) and qwen2-vl (full
    prefill) with sharded decode and KV rebalancing: tokens, groups,
    slots, the migration log and prefill_stats equal the JAX sharded
    session's on every rank."""
    want = _plain(reference["families"][arch]["scenarios"][name])
    for rank, res in enumerate(port[4]):
        assert _plain(res[_FAMILY_KEY[arch]]["scenarios"][name]) == want, \
            rank


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forced_migration_changes_no_token(port, arch):
    res = port[4][0][_FAMILY_KEY[arch]]["scenarios"]
    ref, mig = res["migration_parity"]["ref"], res["migration_parity"]["mig"]
    assert ref["done"] == mig["done"] == [True]
    assert mig["migrations"] == [1] and mig["group"] == [2]
    assert ref["out"] == mig["out"]
    assert mig["stats"]["moved_kv_bytes"] == mig["kv_slot_bytes"]
    assert mig["stats"]["moved_bytes"] == mig["kv_slot_bytes"]
    kv = res["kv_rebalance"]
    assert all(kv["done"]) and sum(kv["migrations"]) >= 1
    assert sum(e["moved_kv_bytes"] for e in kv["log"]) == (
        sum(kv["migrations"]) * kv["kv_slot_bytes"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_slot_migrator_matches_reference(port, reference, families,
                                                arch):
    """The VLM's KV cache and the encoder-decoder's self-attention cache,
    ``cross_k`` / ``cross_v`` (slot axis 1) and positions, shipped whole
    and one layer a chunk: the ranks' rows in rank order equal the JAX
    migrator's global state, with the same stats."""
    from repro_torch.serve import slot_axes
    from repro_torch.serve.slots import _leaves
    cfg = configs.get_smoke(arch)
    want, jstats, jbytes = reference["families"][arch]["migration"]
    axes = _leaves(slot_axes(cfg))
    if cfg.family == "encdec":
        assert axes == [1, 1, 0, 0, 1, 1, 0]
    ranks = [r[_FAMILY_KEY[arch]]["migration"] for r in port[4]]
    for name in ("whole", "chunked"):
        got = [np.concatenate([r[name]["state"][i] for r in ranks], axis=ax)
               for i, ax in enumerate(axes)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for r in ranks:
            assert r[name]["stats"] == jstats
    assert jstats["moved_bytes"] == len(RECURRENT_MOVES) * jbytes
