"""The port's public surface against the JAX package's, on the CPU.

1. An ``ast`` comparison of the two packages: every module of
   ``src/repro/`` has its file in ``src/repro_torch/``, and every public
   top-level name (definitions, ``__all__``, a package's re-exports) and
   every public method of a class both packages have is in the port,
   unless it stands on ``JAX_ONLY`` below with the reason.  A new gap
   fails here.
2. The names ported last, held against the JAX package on the same
   numpy inputs: ``kv_cache_spec_axes``, ``block_decode``,
   ``Mesh.volumes``, ``RefinementForest.leaf_count``, ``Tracer.traced`` /
   ``NullTracer.traced``, ``greedy_map``, ``apply_map``, ``remap``,
   ``ksection_splitters``, ``compute_cut`` and ``Balancer.from_spec``.
"""
import ast
import typing
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: public names of the JAX package with no counterpart of the same name
#: in the port, by module, and why
JAX_ONLY = {
    # the JAX device meshes, partition specs and mesh-axis names: the port
    # runs one process per rank over a ``distributed.Comm``
    "distributed/stages.py": {"AXIS", "build_mesh"},
    "fem/parallel.py": {"AXIS", "device_mesh"},
    "serve/slots.py": {"AXIS", "build_serve_mesh", "slot_pspecs"},
    "serve/__init__.py": {"AXIS", "build_serve_mesh", "slot_pspecs"},
    "launch/dryrun.py": {"KEY", "batch_pspecs", "boxed_shardings",
                         "decode_state_shardings"},
    # ``Boxed`` parameters, their logical-axis trees and the sharding
    # context: the port's parameters are plain tensors whose axes come
    # from ``distributed.sharding.param_axes``
    "distributed/sharding.py": {"Boxed", "axes_tree", "box", "get_mesh",
                                "get_rules", "logical", "pspec_tree",
                                "set_mesh", "set_rules", "stack_axes",
                                "unbox", "use_rules"},
    "distributed/__init__.py": {"Boxed", "DLB_AXIS", "axes_tree", "box",
                                "build_mesh", "logical", "pspec_tree",
                                "set_rules", "shard_map", "stack_axes",
                                "unbox", "use_rules"},
    # the TPU's roofline constants: the port's are ``roofline.H100``
    "launch/roofline.py": {"FUSION_FACTOR", "HBM_BW", "LINK_BW",
                           "PEAK_FLOPS"},
    # the ``init_*`` pytree builders: the port's ``nn.Module``s
    "models/layers.py": {"init_attention", "init_embedding", "init_mlp",
                         "init_rmsnorm"},
    "models/moe.py": {"init_moe"},
    "models/rglru.py": {"init_rglru_block"},
    "models/ssm.py": {"init_mamba2"},
    "models/transformer.py": {"init_block", "init_dec_block", "init_decoder",
                              "init_enc_block", "init_encdec", "init_hybrid",
                              "init_ssm_lm"},
    # the Pallas entry points, their XLA twins (the port's plain versions
    # are ``kernels/ref.py``) and their TPU block sizes
    "kernels/fem_matvec.py": {"BLOCK_C", "LANES", "fem_matvec_jnp",
                              "fem_matvec_pallas"},
    "kernels/flash_attention.py": {"DEFAULT_BK", "DEFAULT_BQ", "NEG_INF",
                                   "flash_attention_pallas"},
    "kernels/ksection_hist.py": {"BLOCK_N", "LANES",
                                 "ksection_histogram_jnp",
                                 "ksection_histogram_pallas"},
    "kernels/prefix_scan.py": {"BLOCK", "exclusive_scan_pallas"},
    "kernels/serve_prefill.py": {"DEFAULT_BLOCK", "NEG_INF",
                                 "packed_attention_jnp",
                                 "packed_attention_pallas"},
    "kernels/sfc_keys.py": {"BLOCK", "sfc_keys_pallas"},
    # the jitted greedy loop (the port's is ``greedy_map_torch``) and the
    # pytree registration of specs (the port traces nothing)
    "core/remap.py": {"greedy_map_jnp"},
    "core/spec.py": {"register_spec_pytree"},
    "core/__init__.py": {"greedy_map_jnp", "register_spec_pytree"},
}
#: public methods with no counterpart: the session's jax device mesh
#: (the port's sharded session takes ``comm=``)
JAX_ONLY_METHODS = {("fem/adapt.py", "AdaptiveSession", "device_mesh")}


def _surface(path: Path):
    """(public names, {class: public methods}) of one module: top-level
    definitions and assignments, ``__all__``, and in a package's
    ``__init__`` the names it imports (typing names aside)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes[node.name] = {
                    n.name for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not n.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names |= {e.value for e in node.value.elts}
                elif isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names
                      if not hasattr(typing, a.asname or a.name)}
    return {n for n in names if not n.startswith("_")}, classes


def _imported(path: Path):
    """Every name a port module binds by an import (a re-export counts)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {a.asname or a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_every_reference_module_has_its_port():
    missing = [m for m in REF_MODULES if not (PORT / m).exists()]
    assert missing == []
    for m in ("deprecation.py", "core/balancer.py",
              "distributed/balancer.py"):
        assert (PORT / m).exists(), m
    assert set(JAX_ONLY) <= set(REF_MODULES)


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_name_is_ported_or_jax_only(module):
    ref_names, ref_classes = _surface(REF / module)
    port_names, port_classes = _surface(PORT / module)
    jax_only = JAX_ONLY.get(module, set())
    missing = ref_names - port_names - _imported(PORT / module) - jax_only
    assert missing == set(), f"{module}: not in the port: {sorted(missing)}"
    # a JAX-only entry the port has after all is stale
    assert not (jax_only & port_names), sorted(jax_only & port_names)
    assert jax_only <= ref_names, sorted(jax_only - ref_names)
    for cls, methods in ref_classes.items():
        if cls not in port_classes:
            continue
        gone = {m for m in methods - port_classes[cls]
                if (module, cls, m) not in JAX_ONLY_METHODS}
        assert gone == set(), f"{module}: {cls} lacks {sorted(gone)}"


# --- the names ported last ---------------------------------------------------

def test_kv_cache_spec_axes_match():
    from repro.serve import decode as jd
    from repro_torch.serve import decode as td
    assert td.kv_cache_spec_axes() == jd.kv_cache_spec_axes()


@pytest.fixture(scope="module", params=["llama3_8b", "phi35_moe_42b"])
def smoke(request):
    from repro import configs as jconfigs
    from repro.models import init_model as j_init_model
    from repro_torch import configs
    from repro_torch.interop import params_from_jax
    jcfg = jconfigs.get_smoke(request.param)
    cfg = configs.get_smoke(request.param)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def _decode_inputs(cfg, b=3, S=12):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, cfg.n_kv_heads, S, cfg.hd)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = np.array([0, 5, 11], np.int32)
    stored = np.where(np.arange(S)[None] < pos[:, None], np.arange(S)[None],
                      -1).astype(np.int32)
    return x, ck, cv, stored, pos


def test_block_decode_matches_the_reference_block(smoke):
    """The port's ``block_decode`` against the reference block's own
    steps (``attention_decode``, then the MLP or MoE).  The reference's
    ``block_decode`` leaves out ``stored_pos``, which its
    ``attention_decode`` requires, so it raises ``TypeError`` on every
    call; so does the port's without it."""
    from repro.models import layers as JL
    from repro.models import moe as JM
    from repro.models import transformer as JT
    from repro_torch.models import block_decode
    jcfg, cfg, params, model = smoke
    p0 = jax.tree.map(lambda a: a[0], params["layers"])
    x, ck, cv, stored, pos = _decode_inputs(cfg)
    jx = jnp.asarray(x)
    h = JL.rmsnorm(jx, p0["ln_attn"].value)
    y, jk, jv = JL.attention_decode(
        p0["attn"], h, jcfg, cache_k=jnp.asarray(ck),
        cache_v=jnp.asarray(cv), stored_pos=jnp.asarray(stored),
        pos=jnp.asarray(pos))
    jx = jx + y
    h = JL.rmsnorm(jx, p0["ln_mlp"].value)
    jy = (JM.moe_apply(p0["moe"], h, jcfg)[0] if "moe" in p0
          else JL.mlp_apply(p0["mlp"], h, jcfg))
    want = jx + jy
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    got, tk, tv = block_decode(model.layers[0], t(x), cfg, pos=t(pos),
                               cache_k=t(ck), cache_v=t(cv),
                               stored_pos=t(stored))
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    with pytest.raises(TypeError, match="stored_pos"):
        JT.block_decode(p0, jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
                        cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv))
    with pytest.raises(TypeError, match="stored_pos"):
        block_decode(model.layers[0], t(x), cfg, pos=t(pos), cache_k=t(ck),
                     cache_v=t(cv))


def test_mesh_volumes_and_leaf_count_match():
    import repro.fem as JF
    import repro_torch.fem as TF
    from repro.core.rtree import RefinementForest as JRF
    from repro_torch.core.rtree import RefinementForest as TRF
    tm = TF.cylinder_mesh(8, 2, length=4.0, radius=0.5)
    jm = JF.cylinder_mesh(8, 2, length=4.0, radius=0.5)
    np.testing.assert_array_equal(tm.volumes(), jm.volumes())
    assert tm.volumes().sum() > 0
    tf, jf = TRF.from_roots(5), JRF.from_roots(5)
    assert tf.leaf_count() == jf.leaf_count() == 5
    for nodes in (np.array([0, 3]), np.array([5, 8])):
        np.testing.assert_array_equal(tf.split(nodes), jf.split(nodes))
        assert tf.leaf_count() == jf.leaf_count()
    assert tf.leaf_count() == 9


def _traced_run(tel):
    """Spans a run records through ``Tracer.traced`` (bound to the
    tracer) and ``NullTracer.traced`` (the active tracer, resolved per
    call)."""
    tr = tel.Tracer()
    outer = tr.traced("outer", block=True)(lambda v: [v, inner(v)])
    inner = tel.NullTracer().traced("inner", step=1)(lambda v: v + 1)
    with tel.tracing(tr):
        out = outer(1)
    plain = tel.NullTracer().traced()(lambda v: v * 2)(4)
    return out, plain, [(e.name, e.depth, e.attrs) for e in tr.events]


def test_tracer_traced_matches_reference():
    from repro import telemetry as jtel
    from repro_torch import telemetry as ttel
    got, want = _traced_run(ttel), _traced_run(jtel)
    assert got == want
    assert [e[0] for e in got[2]] == ["inner", "outer"]


def test_greedy_map_apply_map_and_remap_match():
    rng = np.random.default_rng(0)
    for shape in ((8, 8), (3, 5), (5, 3)):
        S = rng.integers(0, 50, shape).astype(np.float32)
        np.testing.assert_array_equal(T.greedy_map(S), J.greedy_map(S))
    n, p = 4000, 8
    old = rng.integers(0, p, n)
    new = np.where(rng.random(n) < 0.7, (old + 3) % p, rng.integers(0, p, n))
    w = rng.integers(1, 4, n).astype(np.float32)
    perm = rng.permutation(p)
    np.testing.assert_array_equal(
        T.apply_map(torch.as_tensor(new), perm).numpy(),
        np.asarray(J.apply_map(jnp.asarray(new), jnp.asarray(perm))))
    for use_host in (True, False):
        tp, tperm = T.remap(torch.as_tensor(old), torch.as_tensor(new),
                            torch.as_tensor(w), p, use_host=use_host)
        jp, jperm = J.remap(jnp.asarray(old), jnp.asarray(new),
                            jnp.asarray(w), p, use_host=use_host)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
        assert not np.array_equal(tperm.numpy(), np.arange(p))


@pytest.mark.parametrize("k,iters,tol", [(8, 12, 0.0), (4, 3, 0.0),
                                         (8, 12, 0.5)])
def test_ksection_splitters_match(k, iters, tol):
    from repro.core import partition1d as jp1d
    from repro_torch.core import partition1d as tp1d
    rng = np.random.default_rng(k + iters)
    keys = rng.integers(0, 1 << 20, 3000).astype(np.float32)
    w = rng.integers(1, 4, 3000).astype(np.float32)
    p = 16
    targets = np.float32(w.sum()) * np.arange(1, p, dtype=np.float32) / p
    lo, hi = np.float32(keys.min()), np.float32(keys.max() + 1)
    blo = np.full(p - 1, lo, np.float32)
    bhi = np.full(p - 1, hi, np.float32)
    tk, tw = torch.as_tensor(keys), torch.as_tensor(w)
    got = tp1d.ksection_splitters(
        torch.as_tensor(targets), torch.as_tensor(blo), torch.as_tensor(bhi),
        lambda c: tp1d.weight_below(tk, tw, c), k=k, iters=iters, tol=tol)
    jk, jw = jnp.asarray(keys), jnp.asarray(w)
    want = jp1d.ksection_splitters(
        jnp.asarray(targets), jnp.asarray(blo), jnp.asarray(bhi),
        lambda c: jp1d.weight_below(jk, jw, c), k=k, iters=iters, tol=tol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(T.ksection_splitters_counted(
        torch.as_tensor(targets), torch.as_tensor(blo), torch.as_tensor(bhi),
        lambda c: tp1d.weight_below(tk, tw, c), k=k, iters=iters,
        tol=tol)[0].numpy(), got.numpy())


def test_compute_cut_and_balancer_from_spec_match():
    rng = np.random.default_rng(2)
    n = 2000
    coords = rng.random((n, 3)).astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    adj = rng.integers(0, n, (4 * n, 2))
    for oneD in ("sorted", "ksection"):
        tspec = T.BalanceSpec(p=16, oneD=oneD)
        jspec = J.BalanceSpec(p=16, oneD=oneD)
        tb = T.Balancer.from_spec(tspec, device="cpu")
        assert type(tb) is T.Balancer and tb.device.type == "cpu"
        tr = tb.balance(torch.as_tensor(w), coords=torch.as_tensor(coords))
        jr = J.Balancer.from_spec(jspec).balance(
            jnp.asarray(w), coords=jnp.asarray(coords))
        np.testing.assert_array_equal(tr.parts.numpy(), np.asarray(jr.parts))
        got = T.compute_cut(tr.parts, adj)
        assert int(got) == int(J.compute_cut(jr.parts, jnp.asarray(adj)))
        assert int(T.compute_cut(tr.parts.numpy(), torch.as_tensor(adj))) \
            == int(got) > 0
