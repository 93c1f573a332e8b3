"""The sharding rules, the mesh and the ZeRO rule against the JAX package,
for all ten configurations at their published sizes.

``arch_rules`` and ``decode_rules`` (``launch/mesh.py``) are dict logic,
``adapt_rules`` is the reference launcher's adaptation of the rules to a
small model axis (``repro/launch/train.py``, lines 64-71, repeated here
as the oracle), ``param_axes`` gives each port parameter the axes of the
reference leaf that holds it (``axes_tree`` of ``init_model``'s tree,
built with ``jax.eval_shape``, so no weights exist on either side: the
port's model is built on the ``meta`` device), and ``zero_pspec``
folds the data axis into the same dims as the reference's.  All equal.
"""
import jax
import pytest

from repro import configs as jconfigs
from repro.distributed.sharding import Boxed
from repro.distributed.sharding import DEFAULT_RULES as J_DEFAULT_RULES
from repro.distributed.sharding import spec_for as j_spec_for
from repro.launch import mesh as jmesh
from repro.models import init_model as j_init_model
from repro.train.optimizer import zero_pspec as j_zero_pspec
from repro_torch import configs
from repro_torch.distributed.sharding import (DEFAULT_RULES, param_axes,
                                              spec_for, stacked)
from repro_torch.launch import mesh
from repro_torch.models import init_model
from repro_torch.train import zero_pspec

ARCHS = list(configs.ARCH_IDS)


def _j_adapt(rules, cfg, m):
    """The reference launcher's loop (repro/launch/train.py:65-71)."""
    rules = dict(rules)
    for name in ("heads", "mlp", "vocab", "expert", "head_dim"):
        dim = {"heads": cfg.n_heads, "mlp": max(cfg.d_ff, 1),
               "vocab": cfg.vocab, "expert": max(cfg.n_experts, 1),
               "head_dim": cfg.hd}[name]
        if rules.get(name) == "model" and dim % m != 0:
            rules[name] = None
    return rules


_J_LEAVES = {}


def _j_leaves(arch):
    """{leaf key: Boxed of ShapeDtypeStruct} of the reference's tree at
    full size; the key joins the path's dict keys and list indices with
    '.' (``layers.attn.wq``; the hybrid's ``layers.3.attn.wq``)."""
    if arch not in _J_LEAVES:
        cfg = jconfigs.get_config(arch)
        tree = jax.eval_shape(lambda: j_init_model(cfg,
                                                   jax.random.PRNGKey(0)))
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, Boxed))[0]
        _J_LEAVES[arch] = (tree, {
            ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): b for path, b in flat})
    return _J_LEAVES[arch]


def _leaf_key(cfg, name):
    """The reference leaf key of a port parameter name."""
    st = stacked(cfg, name)
    if st is None:
        return name
    return ".".join(name.split(".")[:1] + name.split(".")[2:])


def _port_meta(arch):
    cfg = configs.get_config(arch)
    return cfg, init_model(cfg, seed=None, device="meta")


def test_default_rules_and_spec_for_equal_the_reference():
    assert DEFAULT_RULES == J_DEFAULT_RULES
    axes = ("batch", None, "heads", "vocab", "kv_heads")
    assert spec_for(axes, DEFAULT_RULES) == tuple(
        j_spec_for(axes, J_DEFAULT_RULES))
    assert spec_for(axes, None) == tuple(j_spec_for(axes, None)) == ()


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_and_decode_rules_equal_the_reference(arch, multi_pod):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert mesh.batch_axes(multi_pod) == jmesh.batch_axes(multi_pod)
    assert mesh.arch_rules(arch, cfg, multi_pod=multi_pod) == \
        jmesh.arch_rules(arch, jcfg, multi_pod=multi_pod)
    for batch in (1, 16, 32, 48):
        assert mesh.decode_rules(arch, cfg, multi_pod=multi_pod,
                                 batch=batch) == \
            jmesh.decode_rules(arch, jcfg, multi_pod=multi_pod, batch=batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_small_mesh_adaptation_equals_the_launchers(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    base = jmesh.arch_rules(arch, jcfg)
    for m in (1, 2, 3, 4, 8, 16):
        assert mesh.adapt_rules(base, cfg, m) == _j_adapt(base, jcfg, m)
    assert mesh.train_rules(cfg) == _j_adapt(base, jcfg, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_are_the_reference_leaves_axes(arch):
    cfg, model = _port_meta(arch)
    _, leaves = _j_leaves(arch)
    axes = param_axes(cfg)
    shapes = dict(model.named_parameters())
    assert set(axes) == set(shapes)
    seen = set()
    for name, a in axes.items():
        key = _leaf_key(cfg, name)
        leaf = leaves[key]
        seen.add(key)
        assert a == tuple(leaf.axes), name
        want = leaf.value.shape[1:] if stacked(cfg, name) else leaf.value.shape
        assert tuple(shapes[name].shape) == tuple(want), name
    assert seen == set(leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_pspec_folds_data_into_the_reference_dims(arch):
    """For meshes (d, m) of 4 x 1, 8 x 1, 2 x 1 and 16 x 1 under the
    launcher's adapted rules, and on the production (16, 16) mesh (one pod
    and two), every parameter's moment spec equals the reference leaf's."""
    cfg, model = _port_meta(arch)
    tree, leaves = _j_leaves(arch)
    jcfg = jconfigs.get_config(arch)
    cases = [(_j_adapt(jmesh.arch_rules(arch, jcfg), jcfg, 1), ("data",), d)
             for d in (2, 4, 8, 16)]
    cases += [(jmesh.arch_rules(arch, jcfg, multi_pod=mp),
               jmesh.batch_axes(mp), 16 * (2 if mp else 1))
              for mp in (False, True)]
    for rules, data_axes, d in cases:
        jspecs = j_zero_pspec(tree, rules, data_axes, d)
        jflat = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): tuple(p) for path, p in jflat}
        assert set(want) == set(leaves)
        got = zero_pspec(cfg, model, rules, data_axes, d)
        for name, spec in got.items():
            assert spec == want[_leaf_key(cfg, name)], (name, d, spec)


@pytest.mark.parametrize("d,m", [(1, 1), (4, 1), (2, 2), (1, 16)])
def test_make_mesh_runs_a_data_axis_only(d, m, monkeypatch):
    """``make_mesh(comm, d, m)`` puts rank r at data index r // m and
    model index r % m (``jax.make_mesh``'s device order): its data group
    is the ranks of its model index, its model group those of its data
    index; a group of one rank is None and a group of the whole world is
    the comm itself.  Every rank creates every new group in the same
    order (``torch.distributed.new_group`` is collective over the
    world); a mesh that does not fill the world raises."""
    import types

    import torch.distributed as dist

    import repro_torch.distributed as rdist
    created = []
    monkeypatch.setattr(dist, "new_group",
                        lambda ranks: created.append(list(ranks)) or
                        list(ranks))

    class FakeComm:
        def __init__(self, group, device=None):
            self.members, self.device = group, device

    monkeypatch.setattr(rdist, "Comm", FakeComm)
    p = d * m
    orders = []
    for r in range(p):
        created.clear()
        comm = types.SimpleNamespace(size=p, rank=r, device="cpu")
        got = mesh.make_mesh(comm if p > 1 else None, d, m)
        orders.append(list(created))
        for group, want, index in (
                (got.data, [j * m + r % m for j in range(d)], r // m),
                (got.model, [r // m * m + j for j in range(m)], r % m)):
            assert want.index(r) == index
            if len(want) == 1:
                assert group is None
            elif len(want) == p:
                assert group is comm
            else:
                assert group.members == want and group.device == "cpu"
    assert all(o == orders[0] for o in orders)
    assert len(orders[0]) == (d + m if 1 < d < p else 0)
    with pytest.raises(ValueError, match="ranks"):
        mesh.make_mesh(types.SimpleNamespace(size=p, rank=0), d + 1, m)
