"""Mesh definitions and per-architecture sharding rules.  Counterpart of
``repro/launch/mesh.py``, plus the training launcher's adaptation of the
rules to a small mesh (``adapt_rules``, the reference's
``launch/train.py`` lines 64-71) and ``make_mesh``, the counterpart of
``jax.make_mesh((d, m), ("data", "model"))`` over a ``Comm``: each
rank's data group and model group.

The rules are plain dicts from logical axis names to mesh axis names
(``distributed.sharding``): nothing here touches a device.  On a model
axis wider than 1 every family trains under the launcher's rules
(``train_rules``): tensor- and expert-parallel where the rules slice a
leaf (``models.layers``, ``models.rglru``, ``models.moe``), replicated
on every model rank where they slice none (mamba2 at full width).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

from ..models.config import ModelConfig

MODEL_AXIS_SIZE = 16


class ProductionMesh(NamedTuple):
    """The production mesh as the JAX package's ``make_production_mesh``
    builds it: its ``shape`` and axis ``names``; rank r's coordinates are
    ``coords(r)``, in ``jax.make_mesh``'s device order (row-major, the
    model axis fastest)."""
    shape: Tuple[int, ...]
    names: Tuple[str, ...]

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.names.index(name)]

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index on each axis."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} of a mesh of {self.size}")
        out = {}
        for name, d in zip(reversed(self.names), reversed(self.shape)):
            out[name] = rank % d
            rank //= d
        return {n: out[n] for n in self.names}


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """16x16 ("data", "model"), or 2x16x16 ("pod", "data", "model") with
    ``multi_pod``: a description of the mesh, which starts no process
    (``make_mesh`` is the live counterpart over a ``Comm``)."""
    if multi_pod:
        return ProductionMesh((2, 16, MODEL_AXIS_SIZE),
                              ("pod", "data", "model"))
    return ProductionMesh((16, MODEL_AXIS_SIZE), ("data", "model"))


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def arch_rules(arch: str, cfg: ModelConfig, *, multi_pod: bool = False
               ) -> Dict:
    """Logical-axis -> mesh-axis rules of an architecture on the
    production mesh (model axis of 16): batch over (pod,) data; heads,
    mlp hidden and vocab over model where the dims divide it; head_dim
    over model where the heads do not divide and head_dim does
    (recurrentgemma); MoE experts over model (the expert weights are
    stored pre-blocked for it) and the MoE's mlp replicated."""
    b = batch_axes(multi_pod)
    m = MODEL_AXIS_SIZE
    rules = {
        "batch": b,
        "seq": None,
        "embed": None,
        "heads": "model" if cfg.n_heads % m == 0 else None,
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model" if cfg.vocab % m == 0 else None,
        "layers": None,
        "expert_router": None,
    }
    if cfg.n_heads % m != 0 and cfg.hd % m == 0:
        rules["head_dim"] = "model"
    if cfg.n_experts > 0:
        rules["expert"] = "model"
        rules["mlp"] = None
    return rules


def decode_rules(arch: str, cfg: ModelConfig, *, multi_pod: bool = False,
                 batch: int = 1) -> Dict:
    """Rules of the serve steps: the batch replicated where it does not
    divide the data ranks (16 a pod), and head_dim never on model (the
    KV cache's sequence takes the model axis)."""
    r = arch_rules(arch, cfg, multi_pod=multi_pod)
    world_b = 16 * (2 if multi_pod else 1)
    if batch % world_b != 0:
        r["batch"] = None
    if r.get("head_dim") == "model":
        r["head_dim"] = None
    return r


def adapt_rules(rules: Dict, cfg: ModelConfig, m: int) -> Dict:
    """The training launcher's rules on a mesh whose model axis has ``m``
    ranks: a copy of ``rules`` with "model" dropped from each of heads,
    mlp, vocab, expert and head_dim whose dim ``m`` does not divide.
    (With ``m = 1`` every dim divides, so those axes keep "model" and
    are not free for the ZeRO dim.)"""
    rules = dict(rules)
    # the expert weights' stored rows: ep_shards of them when the config
    # pre-blocks them for an expert-parallel axis (grok's 8 experts as 16
    # f-slices), else one an expert
    dims = {"heads": cfg.n_heads, "mlp": max(cfg.d_ff, 1),
            "vocab": cfg.vocab,
            "expert": max(cfg.ep_shards or cfg.n_experts, 1),
            "head_dim": cfg.hd}
    for name, dim in dims.items():
        if rules.get(name) == "model" and dim % m != 0:
            rules[name] = None
    return rules


def train_rules(cfg: ModelConfig, m: int = 1) -> Dict:
    """The rules the training launcher runs ``cfg`` with on a ``(d, m)``
    mesh: ``arch_rules`` of one pod, adapted to ``m`` -- the reference
    launcher's rules, for every family.  Where the heads do not divide
    the production axis (recurrentgemma, every SMOKE config) head_dim is
    on "model" (``models.layers.attention_apply`` runs that layout);
    mamba2's mixer carries no axis the rules keep on "model", so it runs
    whole on every model rank.  A dim on "model" that ``m`` does not
    divide (an RG-LRU leaf at ``m = 3``, where the adaptation keeps
    "mlp" for ``d_ff`` alone) raises in ``model_slices``."""
    return adapt_rules(arch_rules(cfg.name, cfg), cfg, m)


def serve_rules(cfg: ModelConfig, m: int = 1, *, multi_pod: bool = False,
                batch: int = 1) -> Dict:
    """The rules the serving steps run ``cfg`` with on a model axis of
    ``m`` ranks (``serve.decode.prefill`` / ``decode_step`` with
    ``model=``): ``decode_rules`` adapted to ``m`` as the training
    launcher adapts ``arch_rules``, with the KV cache's sequence on
    "model" (``"cache_seq"``).  Prefill takes them too, where the
    reference's dry-run prefills under ``arch_rules`` (head_dim on
    "model" for recurrentgemma): the cache's sequence takes that axis,
    so no head_dim slice meets it."""
    rules = adapt_rules(decode_rules(cfg.name, cfg, multi_pod=multi_pod,
                                     batch=batch), cfg, m)
    rules["cache_seq"] = "model"
    return rules


class Mesh(NamedTuple):
    """One rank's groups of a ``(d, m)`` mesh: its ``Comm`` over the
    ranks that share its model index (``data``) and over those that share
    its data index (``model``); None for an axis of one rank."""
    data: Optional[object]
    model: Optional[object]


def make_mesh(comm, d: int, m: int) -> Mesh:
    """The counterpart of ``jax.make_mesh((d, m), ("data", "model"))``
    over ``comm``'s ranks (None: one rank): rank ``r`` sits at data index
    ``r // m`` and model index ``r % m``, the device order of
    ``jax.make_mesh``.  Its data group is the ranks ``{j m + r % m}``
    (data rank ``r // m``), its model group the ranks ``{(r // m) m +
    j}`` (model rank ``r % m``).  A group of the whole world is ``comm``
    itself; the others are new process groups, which every rank creates,
    all of them, in the same order (``new_group`` is collective over the
    world even for the ranks outside the group)."""
    size = 1 if comm is None else comm.size
    if d < 1 or m < 1 or d * m != size:
        raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, have {size}")
    if size == 1:
        return Mesh(None, None)
    if m == 1:
        return Mesh(comm, None)
    if d == 1:
        return Mesh(None, comm)
    import torch.distributed as dist
    from ..distributed import Comm
    r = comm.rank
    mine = {}
    for j in range(m):                  # the data groups, by model index
        g = dist.new_group([i * m + j for i in range(d)])
        if j == r % m:
            mine["data"] = g
    for i in range(d):                  # the model groups, by data index
        g = dist.new_group([i * m + j for j in range(m)])
        if i == r // m:
            mine["model"] = g
    return Mesh(Comm(mine["data"], device=comm.device),
                Comm(mine["model"], device=comm.device))
