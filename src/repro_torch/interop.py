"""Carrying state between the JAX package and this one.

The FEM side's state is data: the mesh (with its refinement forest and
the per-leaf payloads -- parts, cached SFC keys) and the specs.  Specs
cross through ``to_dict`` / ``from_dict``.  Meshes cross through the
functions below, which copy arrays and never import the other package:
``mesh_from_numpy`` takes any object (or dict) with the ``Mesh`` fields,
e.g. a ``repro.fem.Mesh``; ``mesh_to_numpy`` gives a plain dict from
which the caller rebuilds a mesh of either package.  The sharded FEM
layer's state crosses as one rank's pieces: ``halo_plan_from_jax`` and
``sharded_elements_from_jax`` take the JAX package's ``HaloPlan`` and
``(p, C, ...)`` ``ShardedElements`` (any object with their fields).  The serving side's
state is the model's weights: ``params_from_jax`` builds a port model
from the JAX package's parameter tree.  The training side adds the
optimizer's moments (``opt_state_from_jax``, through the same layer
mapping, ``tensors_from_jax``) and whole checkpoints the JAX package
wrote (``checkpoint_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .core.rtree import RefinementForest
from .device import resolve_device
from .distributed.sharding import narrow
from .fem.halo import HaloPlan
from .fem.mesh import Mesh
from .fem.parallel import ShardedElements
from .models.config import ModelConfig
from .models.model import init_model
from .train.checkpoint import read_checkpoint
from .train.optimizer import OptState

MESH_ARRAYS = ("verts", "node_tets", "node_tag", "node_mid", "leaf_nodes")
FOREST_ARRAYS = ("parent", "child0", "child1")


def _get(src: Any, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _payload_array(a) -> np.ndarray:
    a = np.array(a, copy=True)
    # unsigned keys (the JAX package's uint32) become int64, same values
    return a.astype(np.int64) if a.dtype.kind == "u" else a


def mesh_from_numpy(src: Any) -> Mesh:
    """A port ``Mesh`` holding copies of ``src``'s arrays.

    ``src``: a mesh of either package, or a dict as ``mesh_to_numpy``
    returns.  The copy shares nothing with ``src``."""
    forest = _get(src, "forest")
    f = RefinementForest(
        **{k: np.array(_get(forest, k), np.int64) for k in FOREST_ARRAYS},
        n_roots=int(_get(forest, "n_roots")))
    kw = {k: np.array(_get(src, k), copy=True) for k in MESH_ARRAYS}
    return Mesh(forest=f,
                edge_mid={int(k): int(v) for k, v in _get(src, "edge_mid").items()},
                leaf_payload={k: _payload_array(v)
                              for k, v in _get(src, "leaf_payload").items()},
                **kw)


def mesh_to_numpy(mesh: Mesh) -> Dict[str, Any]:
    """Plain copies of a port ``Mesh``'s fields: the mesh arrays,
    ``forest`` as a dict of its arrays and ``n_roots``, ``edge_mid`` and
    ``leaf_payload``.  ``mesh_from_numpy`` takes it back; a mesh of the
    JAX package is ``Mesh(**d)`` with ``forest=RefinementForest(**d['forest'])``."""
    out: Dict[str, Any] = {k: np.array(getattr(mesh, k), copy=True)
                           for k in MESH_ARRAYS}
    out["forest"] = {k: np.array(getattr(mesh.forest, k), copy=True)
                     for k in FOREST_ARRAYS}
    out["forest"]["n_roots"] = int(mesh.forest.n_roots)
    out["edge_mid"] = dict(mesh.edge_mid)
    out["leaf_payload"] = {k: np.array(v, copy=True)
                           for k, v in mesh.leaf_payload.items()}
    return out


HALO_ARRAYS = ("local_verts", "owned_mask", "global_to_local", "send_idx",
               "recv_idx", "owner")
HALO_SIZES = ("p", "n_verts", "V", "H", "n_local", "n_owned",
              "n_ghost_total")


def halo_plan_from_jax(plan: Any) -> HaloPlan:
    """A port ``HaloPlan`` holding numpy copies of ``plan``'s arrays (a
    plan of either package)."""
    return HaloPlan(**{k: np.array(getattr(plan, k), copy=True)
                       for k in HALO_ARRAYS},
                    **{k: getattr(plan, k) for k in HALO_SIZES})


def sharded_elements_from_jax(sel: Any, rank: int, *, device=None
                              ) -> ShardedElements:
    """Rank ``rank``'s row of the JAX package's ``(p, C, ...)`` element
    packing as a port ``ShardedElements`` (tensors on ``device``,
    default CPU; the plan converted by ``halo_plan_from_jax``)."""
    dev = torch.device("cpu" if device is None else device)
    row = lambda a: torch.as_tensor(np.array(np.asarray(a)[rank]),  # noqa
                                    device=dev)
    halo = None if sel.halo is None else halo_plan_from_jax(sel.halo)
    return ShardedElements(row(sel.tets).to(torch.int32), row(sel.grads),
                           row(sel.vol), int(sel.n_verts), int(sel.p), rank,
                           halo=halo, layout=sel.layout,
                           n_interface=sel.n_interface)


def _tensor(leaf, device) -> torch.Tensor:
    """A leaf of the JAX package's parameter tree (a ``Boxed`` with its
    ``value``, or a bare array) as a tensor.  bfloat16 arrays, which
    numpy holds as an extension type torch cannot read, cross as their
    16-bit patterns.  A tensor (a checkpoint's array) is copied."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device, copy=True)
    a = np.asarray(getattr(leaf, "value", leaf))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict by dotted name (``state_dict`` style)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def _layer_tensors(layers, n: int, dev) -> list:
    """One dict of tensors a layer from the JAX package's ``layers``: a
    list of per-layer dicts, or one dict with every leaf stacked over the
    layers on axis 0."""
    if isinstance(layers, (list, tuple)):
        if len(layers) != n:
            raise ValueError(f"{len(layers)} JAX layers for {n} blocks")
        return [{k: _tensor(v, dev) for k, v in _flatten(lp).items()}
                for lp in layers]
    stacked = {k: _tensor(v, dev) for k, v in _flatten(layers).items()}
    for k, w in stacked.items():
        if w.shape[0] != n:
            raise ValueError(f"JAX leaf {k} stacks {w.shape[0]} layers for "
                             f"{n} blocks")
    return [{k: w[li] for k, w in stacked.items()} for li in range(n)]


def params_from_jax(params: Dict, cfg: ModelConfig, *, device=None,
                    slices: Optional[Dict] = None) -> torch.nn.Module:
    """A port model holding copies of the JAX package's parameters
    (``repro.models.init_model``'s tree: ``embed`` {tok, head}, the layers
    and ``ln_f``).  The layers are, by family:

    * dense / MoE / VLM: ``layers``, one dict with every leaf stacked over
      the layers on axis 0 -- ``ln_attn``, ``attn``, ``ln_mlp`` and
      ``mlp`` {wi, wg, wo} or ``moe`` {router, wi, wg, wo};
    * SSM: ``layers`` stacked the same way -- ``ln`` and ``mixer``
      {in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_w, out_proj};
    * hybrid: ``layers``, a Python list with one dict a layer, whose keys
      differ by the layer's kind -- ``ln_mix``, ``ln_mlp``, ``mlp`` and
      ``attn`` or ``rglru`` {in_x, in_gate, conv_w, conv_b, w_r, b_r, w_i,
      b_i, lam, out};
    * encoder-decoder: ``enc_layers`` (``ln_attn``, ``attn``, ``ln_mlp``,
      ``mlp`` {wi, wo}) and ``dec_layers`` (``ln_self``, ``self_attn``,
      ``ln_cross``, ``cross_attn``, ``ln_mlp``, ``mlp``), both stacked,
      and ``ln_enc``.

    Leaves may be ``Boxed`` or bare arrays; the layouts are the same in
    both packages, so nothing is transposed.  Every block must have
    exactly its JAX layer's parameter names, and the layer exactly the
    block's.  ``slices`` (a model rank's
    ``distributed.sharding.model_slices``) builds that rank's model: each
    leaf is read on the host and only its slice reaches ``device``."""
    model = init_model(cfg, seed=None, device=device, slices=slices)
    tensors = tensors_from_jax(
        params, cfg, device="cpu" if slices else model.ln_f.device)
    own = dict(model.named_parameters())
    if set(own) != set(tensors):
        raise ValueError(
            f"parameter names differ: port only "
            f"{sorted(set(own) - set(tensors))[:6]}, JAX only "
            f"{sorted(set(tensors) - set(own))[:6]}")
    with torch.no_grad():
        for name, w in tensors.items():
            own[name].copy_(narrow(w, (slices or {}).get(name)))
    return model


def tensors_from_jax(tree: Dict, cfg: ModelConfig, *, device=None
                     ) -> Dict[str, torch.Tensor]:
    """The leaves of a tree shaped like the JAX package's parameters (the
    parameters, their gradients, or Adam's ``m`` / ``v``) by the port
    model's parameter names (``state_dict`` style: ``embed.tok``,
    ``layers.3.attn.wq``, ...), copied to ``device`` (default CUDA): the
    layer mapping ``params_from_jax`` describes."""
    dev = resolve_device(device)
    stacks = ((("enc_layers", cfg.enc_layers), ("dec_layers", cfg.n_layers))
              if cfg.family == "encdec" else (("layers", cfg.n_layers),))
    out = {"embed.tok": _tensor(tree["embed"]["tok"], dev),
           "embed.head": _tensor(tree["embed"]["head"], dev),
           "ln_f": _tensor(tree["ln_f"], dev)}
    if cfg.family == "encdec":
        out["ln_enc"] = _tensor(tree["ln_enc"], dev)
    for stack, n in stacks:
        for i, layer in enumerate(_layer_tensors(tree[stack], n, dev)):
            out.update({f"{stack}.{i}.{k}": w for k, w in layer.items()})
    return out


def opt_state_from_jax(opt: Any, cfg: ModelConfig, *, device=None
                       ) -> OptState:
    """The port's ``OptState`` from the JAX package's (``step``, ``m``,
    ``v``; any object with those fields, or a 3-sequence in that order):
    the moments keyed by the port's parameter names, on ``device``."""
    step, m, v = ((opt.step, opt.m, opt.v) if hasattr(opt, "m")
                  else tuple(opt))
    return OptState(int(np.asarray(step)),
                    tensors_from_jax(m, cfg, device=device),
                    tensors_from_jax(v, cfg, device=device))


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    """Nested dicts from '/'-joined keys; a dict whose keys are all
    indices becomes a list (the hybrid's per-layer list)."""
    root: Dict = {}
    for key, val in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def checkpoint_from_jax(path: str, cfg: ModelConfig,
                        step: Optional[int] = None, *, device=None
                        ) -> Tuple[int, torch.nn.Module, OptState]:
    """``(step, model, opt_state)`` for the port from a checkpoint the JAX
    package's ``repro.train.save`` wrote of ``{"params": params, "opt":
    opt_state}`` (its launcher's layout), ``step=None`` the newest.
    bfloat16 arrays are read as raw words by the manifest's dtype, so no
    bfloat16 numpy type is needed."""
    step, flat = read_checkpoint(path, step)
    tree = _unflatten(flat)
    model = params_from_jax(tree["params"], cfg, device=device)
    return step, model, opt_state_from_jax(tree["opt"], cfg, device=device)
