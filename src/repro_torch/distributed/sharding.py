"""Logical-axis sharding rules.  Counterpart of
``repro/distributed/sharding.py``.

The JAX package annotates every parameter with *logical* axis names
("embed", "heads", "vocab", ...) and maps them to mesh axes through a
rules table (``DEFAULT_RULES``, or ``launch.mesh.arch_rules``);
``spec_for`` turns one tensor's axes into its partition spec, a tuple
with one entry a dim (a mesh axis name, a tuple of them, or None for a
replicated dim).

A torch tensor carries no sharding annotation, so there is no ``Boxed``
here and no ``logical`` constraint: ``param_axes(cfg)`` gives each of
the port model's parameter names (``named_parameters``) the logical axes
of the reference's leaf that holds it -- the ``Boxed.axes`` of
``repro.models.init_model``'s tree.  The reference stacks the layers of
every family but the hybrid on a leading ``"layers"`` axis, and the
port keeps one tensor a layer (``layers.3.attn.wq``), so such a name's
axes begin with ``"layers"`` and have one entry more than its tensor
has dims; ``stacked(cfg, name)`` says which stack and layer it is.

On a model axis of ``m`` ranks, ``model_slices`` gives each parameter's
part on one model rank: the dim its rules put on "model" and rank
``i``'s block ``[i n/m, (i+1) n/m)`` of it (None: replicated), from which
the model is built (``models.init_model(..., slices=)``) and which every
model-parallel layer reads back from its weights' shapes.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

from ..models.config import ModelConfig

DEFAULT_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    # parameters
    "layers": None,
    "expert": "model",
    # optimizer-state extra sharding (ZeRO): fold data into the first
    # tensor-parallel-free dim -- handled in train.optimizer.
}

Axes = Tuple[Optional[str], ...]

#: the stacks of layers; the reference stacks each (but the hybrid's) on
#: a leading "layers" axis
STACKS = ("layers", "enc_layers", "dec_layers")

_ATTN = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
# a parameter's logical axes by its module (the name's next-to-last part)
# and its own name, as the reference's init functions box them
_BY_MODULE = {
    "attn": _ATTN, "self_attn": _ATTN, "cross_attn": _ATTN,
    "mlp": {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")},
    "moe": {"router": ("embed", "expert_router"),
            "wi": ("expert", "embed", "mlp"),
            "wg": ("expert", "embed", "mlp"),
            "wo": ("expert", "mlp", "embed")},
    "mixer": {"in_proj": ("embed", "mlp"), "conv_w": ("mlp", None),
              "conv_b": ("mlp",), "A_log": (None,), "D": (None,),
              "dt_bias": (None,), "norm_w": ("mlp",),
              "out_proj": ("mlp", "embed")},
    "rglru": {"in_x": ("embed", "mlp"), "in_gate": ("embed", "mlp"),
              "conv_w": ("mlp", None), "conv_b": ("mlp",),
              "w_r": ("mlp", None), "b_r": (None,), "w_i": ("mlp", None),
              "b_i": (None,), "lam": (None,), "out": ("mlp", "embed")},
    "embed": {"tok": ("vocab", "embed"), "head": ("embed", "vocab")},
}


def spec_for(axes: Sequence[Optional[str]], rules: Optional[dict]
             ) -> tuple:
    """The partition spec of a tensor with logical ``axes`` under
    ``rules``: each axis's mesh axis (None: replicated); ``()`` without
    rules, as the reference's ``P()``."""
    if rules is None:
        return ()
    return tuple(rules.get(a) if a is not None else None for a in axes)


def stacked(cfg: ModelConfig, name: str) -> Optional[Tuple[str, int]]:
    """(stack, layer index) of a parameter the reference keeps in a leaf
    stacked over the layers, else None (the hybrid's layers are a list of
    leaves in the reference)."""
    parts = name.split(".")
    if cfg.family != "hybrid" and parts[0] in STACKS and parts[1].isdigit():
        return parts[0], int(parts[1])
    return None


def stack_size(cfg: ModelConfig, stack: str) -> int:
    """The layers of one stack."""
    return cfg.enc_layers if stack == "enc_layers" else cfg.n_layers


def _own_axes(name: str) -> Axes:
    parts = name.split(".")
    leaf = parts[-1]
    if leaf.startswith("ln"):
        return ("embed",)
    module = parts[-2] if len(parts) > 1 else ""
    try:
        return _BY_MODULE[module][leaf]
    except KeyError:
        raise KeyError(f"no logical axes for parameter {name!r}") from None


def param_axes(cfg: ModelConfig, names: Optional[Sequence[str]] = None
               ) -> Dict[str, Axes]:
    """The logical axes of each parameter of a ``cfg`` model by its name
    (``names``, default every parameter of ``init_model(cfg)``): the axes
    of the reference leaf that holds it, ``"layers"`` first where the
    reference stacks the layers."""
    if names is None:
        from ..models import init_model
        names = [n for n, _ in init_model(cfg, seed=None,
                                          device="meta").named_parameters()]
    return {n: (("layers",) if stacked(cfg, n) else ()) + _own_axes(n)
            for n in names}


def leaf_shape(cfg: ModelConfig, name: str, shape: Sequence[int]
               ) -> Tuple[int, ...]:
    """The shape of the reference leaf that holds parameter ``name`` of
    ``shape``: the stack's layer count first where it is stacked."""
    st = stacked(cfg, name)
    return ((stack_size(cfg, st[0]),) if st else ()) + tuple(shape)


class Slice(NamedTuple):
    """Rows ``[start, start + size)`` of a tensor's dim ``dim``: the
    arguments of ``Tensor.narrow``."""
    dim: int
    start: int
    size: int


def narrow(t, sl: Optional[Slice]):
    """The part of ``t`` a ``Slice`` covers (a view); ``t`` for None."""
    return t if sl is None else t.narrow(*sl)


def unslice(t, sl: Optional[Slice], model):
    """The one-rank tensor of which ``t`` is this model rank's slice
    ``sl``: every rank's slice all-gathered over the model group
    ``model`` in rank order (a collective); ``t`` itself for None."""
    if sl is None:
        return t
    parts = model.all_gather(t.movedim(sl.dim, 0).contiguous())
    return parts.movedim(0, sl.dim)


def model_slices(cfg: ModelConfig, rules: dict, m: int, i: int,
                 shapes: Optional[Dict[str, Sequence[int]]] = None
                 ) -> Dict[str, Optional[Slice]]:
    """Each parameter's part on model rank ``i`` of ``m`` under ``rules``
    by name: the block ``[i n/m, (i+1) n/m)`` of the one dim whose axis
    the rules map to "model" (n that dim's size in the one-rank model),
    None for a parameter with no such dim or for ``m = 1``.  ``shapes``
    gives the one-rank shapes by name (default those of
    ``init_model(cfg)``).  A dim on "model" that ``m`` does not divide
    raises ``ValueError``."""
    if shapes is None:
        from ..models import init_model
        shapes = {n: tuple(p.shape) for n, p in
                  init_model(cfg, seed=None, device="meta").named_parameters()}
    axes = param_axes(cfg, list(shapes))
    out: Dict[str, Optional[Slice]] = {}
    for name, shape in shapes.items():
        spec = spec_for(axes[name], rules)
        dims = [d for d, a in enumerate(spec) if a == "model"]
        if m == 1 or not dims:
            out[name] = None
            continue
        if len(dims) > 1:
            raise ValueError(f"{name}: more than one dim on 'model' {spec}")
        dim = dims[0] - (1 if stacked(cfg, name) else 0)
        n = shape[dim]
        if n % m:
            raise ValueError(f"{name}: dim {dim} of {n} does not split over "
                             f"{m} model ranks")
        out[name] = Slice(dim, i * (n // m), n // m)
    return out
