"""Mesh definitions and per-architecture sharding rules.  Counterpart of
``repro/launch/mesh.py``, plus the training launcher's adaptation of the
rules to a small mesh (``adapt_rules``, the reference's
``launch/train.py`` lines 64-71) and ``make_mesh``, the counterpart of
``jax.make_mesh((d, m), ("data", "model"))`` over a ``Comm``.

The rules are plain dicts from logical axis names to mesh axis names
(``distributed.sharding``): nothing here touches a device.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models.config import ModelConfig

MODEL_AXIS_SIZE = 16

#: what a model axis wider than 1 waits for
TENSOR_PARALLEL = ("a model axis wider than 1 (tensor and expert "
                   "parallelism) is item 10's rest in ROADMAP.md (queue 1): "
                   "only --mesh Dx1 runs")


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
    dims = {"heads": cfg.n_heads, "mlp": max(cfg.d_ff, 1),
            "vocab": cfg.vocab, "expert": max(cfg.n_experts, 1),
            "head_dim": cfg.hd}
    for name, dim in dims.items():
        if rules.get(name) == "model" and dim % m != 0:
            rules[name] = None
    return rules


def train_rules(cfg: ModelConfig, m: int = 1) -> Dict:
    """The rules the training launcher runs ``cfg`` with on a ``(d, m)``
    mesh: ``arch_rules`` of one pod, adapted to ``m``."""
    return adapt_rules(arch_rules(cfg.name, cfg), cfg, m)


def make_mesh(comm, d: int, m: int):
    """The counterpart of ``jax.make_mesh((d, m), ("data", "model"))``
    over ``comm``'s ranks: this rank's data group (a ``Comm``), None for
    one rank.  Only ``m == 1`` runs, where the data group is ``comm``
    itself (``d`` ranks; ``comm=None`` for one) and there is no model
    group."""
    if m != 1:
        raise ValueError(f"mesh {d}x{m}: {TENSOR_PARALLEL}")
    size = 1 if comm is None else comm.size
    if d != size:
        raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, have {size}")
    return comm if d > 1 else None
