"""Declarative balancing API: ``BalanceSpec`` + stage registry + ``Balancer``.

The paper's DLB step is one fixed pipeline

    keys -> partition1d -> remap -> migrate

* ``BalanceSpec``  -- a frozen dataclass holding every knob of the pipeline,
  with the JAX package's fields, validation and plain-dict round trip, so
  ``BalanceSpec.from_dict(repro_spec.to_dict())`` carries a spec across.
  It names no device.
* stage registry   -- stage functions registered per ``(backend, stage,
  variant)``.  The host backend runs on one device (the card, by
  default); the sharded backend (``distributed.stages``) runs one rank
  per part over a ``torch.distributed`` process group.
* ``Balancer``     -- resolves a spec into the pipeline on a device, applies
  the padding policy, threads warm-start splitters between calls and
  publishes the quality counters.

Padded items carry the sentinel part ``spec.pad_part == p`` in
``old_parts``; the similarity and migration metrics mask it out.

``use_pallas`` means "use the hand-written kernels" here: ``None`` runs
them on CUDA tensors and the plain versions on CPU ones, ``False`` the
plain versions, ``True`` the kernels (a CPU device raises).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from ..segment import segment_sum_any_order
from . import metrics as _metrics
from . import partition1d as _p1d
from .remap import guarded_greedy_perm, similarity_matrix
from .rcb import rcb_partition
from .rtree import partition_dfs
from .sfc import bounding_box, sfc_keys

SFC_METHODS = ("hsfc", "msfc", "hsfc_zoltan")
METHODS = SFC_METHODS + ("rtk", "rcb", "linear")
ONED_SOLVERS = ("sorted", "ksection")
BACKENDS = ("host", "sharded")
PADDINGS = ("pow2", "none")
STAGES = ("keys", "partition1d", "remap", "migrate")


# ---------------------------------------------------------------------------
# Spec base
# ---------------------------------------------------------------------------

class Spec:
    """Mixin for frozen declarative spec dataclasses: ``to_dict`` /
    ``from_dict`` (lossless, JSON-safe, nested specs in ``_NESTED_SPECS``,
    unknown keys rejected) and a validating ``replace``."""

    _NESTED_SPECS: ClassVar[Mapping[str, type]] = {}

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, Spec) else v
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Spec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown {cls.__name__} fields: {sorted(unknown)}")
        kw = dict(d)
        for name, sub in cls._NESTED_SPECS.items():
            if isinstance(kw.get(name), Mapping):
                kw[name] = sub.from_dict(kw[name])
        return cls(**kw)

    def replace(self, **kw) -> "Spec":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# BalanceSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BalanceSpec(Spec):
    """Declarative description of one DLB pipeline.

    p                  number of parts / processes
    method             'rtk' | 'hsfc' | 'msfc' | 'hsfc_zoltan' | 'rcb'
                       | 'linear' (keys = first coordinate, or arrival
                       order when no coords)
    oneD               1-D solver: 'sorted' (exact, one sort) or
                       'ksection' (the paper's histogram search)
    k, iters           k-section branching factor / rounds
    sfc_bits           SFC grid resolution
    use_remap          apply the Oliker--Biswas relabelling
    backend            'host' (one device) | 'sharded' (one rank per part
                       over a process group)
    padding            host backend: 'pow2' pads to the next power of two
                       (the JAX package's compile-reuse policy, kept so
                       results match it); 'none' passes shapes through.
                       The sharded backend always pads to p * C (C a
                       power of two >= min_capacity)
    min_capacity       sharded per-device capacity floor
    execute_migration  sharded: ship payloads with the all_to_all executor
    use_pallas         use the hand-written kernels (SFC keys, the
                       k-section histogram, the segment sums): None = on
                       CUDA tensors, False = plain versions, True = kernels
    warm_start         oneD='ksection': seed each repartition's boxes from
                       the previous call's splitters
    ksection_tol       stop the k-section search once every box is
                       narrower than this (0 = until boxes stall)
    """
    p: int
    method: str = "hsfc"
    oneD: str = "sorted"
    k: int = 8
    iters: int = 12
    sfc_bits: int = 10
    use_remap: bool = True
    backend: str = "host"
    padding: str = "pow2"
    min_capacity: int = 64
    execute_migration: bool = True
    use_pallas: Optional[bool] = None
    warm_start: bool = False
    ksection_tol: float = 0.0

    def __post_init__(self):
        if self.p < 1:
            raise ValueError(f"p must be >= 1, got {self.p}")
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; "
                             f"choose from {METHODS}")
        if self.oneD not in ONED_SOLVERS:
            raise ValueError(f"unknown oneD solver {self.oneD!r}; "
                             f"choose from {ONED_SOLVERS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choose from {BACKENDS}")
        if self.padding not in PADDINGS:
            raise ValueError(f"unknown padding policy {self.padding!r}; "
                             f"choose from {PADDINGS}")

    @property
    def pad_part(self) -> int:
        """Sentinel part id carried by padded items in ``old_parts``: one
        past the last real part, so every mask is ``old_parts < p``."""
        return self.p


# ---------------------------------------------------------------------------
# BalanceResult
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BalanceResult:
    """Result of one balance step; tensors on the balancer's device.

    ``total_v`` / ``max_v`` / ``retained`` are zero without ``old_parts``;
    ``remap_perm`` is the identity when the remap stage did not run.
    ``migration`` holds the sharded all_to_all executor's conservation
    scalars (weight_in, weight_out, items, overflow), or ``None`` when no
    migration ran (always on the host backend)."""
    parts: torch.Tensor          # (n,) int64 part id per item
    part_weights: torch.Tensor   # (p,)
    imbalance: torch.Tensor      # () max/mean part weight
    total_v: torch.Tensor        # () migrated weight (TotalV)
    max_v: torch.Tensor          # () max per-process migrated weight (MaxV)
    retained: torch.Tensor       # () weight that stayed put
    remap_perm: torch.Tensor     # (p,) process assigned to each new part
    migration: Optional[Dict[str, torch.Tensor]] = None
    splitters: Optional[torch.Tensor] = None     # (p-1,) 1-D cuts, if any
    ksection_rounds: Optional[int] = None        # rounds actually run


# ---------------------------------------------------------------------------
# Stage registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[Tuple[str, str, str], Callable] = {}


def register_stage(backend: str, stage: str, variant: str) -> Callable:
    """Decorator: register a stage function for a backend.

    Host stage signatures::

        keys(spec, coords, weights)                  -> keys
        partition1d(spec, keys, weights, coords)     -> parts | (parts, aux)
        remap(spec, old_parts, new_parts, weights)   -> (parts, perm)
        migrate(spec, old_parts, new_parts, weights) -> dict of scalars

    Sharded stages take the same operands (this rank's shard) plus the
    keyword ``comm``.
    """
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; choose from {STAGES}")

    def deco(fn):
        _REGISTRY[(backend, stage, variant)] = fn
        return fn
    return deco


def get_stage(backend: str, stage: str, variant: str) -> Callable:
    _ensure_backend_registered(backend)
    try:
        return _REGISTRY[(backend, stage, variant)]
    except KeyError:
        avail = stage_variants(backend, stage)
        raise ValueError(
            f"no {stage!r} stage variant {variant!r} registered for "
            f"backend {backend!r}; available: {avail}") from None


def _ensure_backend_registered(backend: str) -> None:
    """The sharded stages register when their module is imported."""
    if backend == "sharded":
        from ..distributed import stages  # noqa: F401


def stage_variants(backend: str, stage: str):
    """Registered variant names for (backend, stage)."""
    _ensure_backend_registered(backend)
    return sorted(v for (b, s, v) in _REGISTRY if b == backend and s == stage)


def resolve_variants(spec: BalanceSpec) -> Dict[str, Optional[str]]:
    """Map a spec to the stage variants its pipeline uses (``keys`` is
    ``None`` for the direct partitioners rtk and rcb)."""
    if spec.method in SFC_METHODS:
        return {"keys": "sfc", "partition1d": spec.oneD,
                "remap": "greedy", "migrate": None}
    if spec.method == "linear":
        return {"keys": "linear", "partition1d": spec.oneD,
                "remap": "greedy", "migrate": None}
    return {"keys": None, "partition1d": spec.method,
            "remap": "greedy", "migrate": None}


# ---------------------------------------------------------------------------
# Host stages
# ---------------------------------------------------------------------------

@register_stage("host", "keys", "sfc")
def _keys_sfc_host(spec: BalanceSpec, coords, weights):
    curve = "morton" if spec.method == "msfc" else "hilbert"
    lo, hi = bounding_box(coords)
    return sfc_keys(coords, lo, hi, curve=curve,
                    uniform=spec.method != "hsfc_zoltan", bits=spec.sfc_bits,
                    use_pallas=spec.use_pallas)


@register_stage("host", "keys", "linear")
def _keys_linear_host(spec: BalanceSpec, coords, weights):
    if coords is None:
        return torch.arange(weights.shape[0], device=weights.device)
    return coords[:, 0]


@register_stage("host", "keys", "cached")
def _keys_cached_host(spec: BalanceSpec, coords, weights, *, keys):
    """Pass-through for precomputed keys (the incremental ``KeyCache``
    path: keys came from a frozen bounding box)."""
    return keys


@register_stage("host", "partition1d", "sorted")
def _partition_sorted_host(spec: BalanceSpec, keys, weights, coords,
                           warm=None):
    r = _p1d.sorted_exact(keys, weights, spec.p, use_pallas=spec.use_pallas)
    return r.parts, {"splitters": r.splitters}


@register_stage("host", "partition1d", "ksection")
def _partition_ksection_host(spec: BalanceSpec, keys, weights, coords,
                             warm=None):
    r = _p1d.ksection(keys, weights, spec.p, k=spec.k, iters=spec.iters,
                      warm=warm, tol=spec.ksection_tol,
                      use_pallas=spec.use_pallas)
    return r.parts, {"splitters": r.splitters, "ksection_rounds": r.rounds}


@register_stage("host", "partition1d", "rtk")
def _partition_rtk_host(spec: BalanceSpec, keys, weights, coords, warm=None):
    return partition_dfs(weights, spec.p, use_pallas=spec.use_pallas)


@register_stage("host", "partition1d", "rcb")
def _partition_rcb_host(spec: BalanceSpec, keys, weights, coords, warm=None):
    return rcb_partition(coords, weights, spec.p)


@register_stage("host", "remap", "greedy")
def _remap_greedy_host(spec: BalanceSpec, old_parts, new_parts, weights):
    """Oliker--Biswas relabelling on the device, with the identity guard.
    Padded items (``old_parts == pad_part``) fall outside S."""
    p = spec.p
    tr = telemetry.get_tracer()
    with tr.span("remap/similarity"):
        S = similarity_matrix(old_parts, new_parts, weights, p, p,
                              use_pallas=spec.use_pallas)
    # one span for the greedy loop's p rounds: a span a round would cost
    # more than it shows
    with tr.span("remap/greedy"):
        perm = guarded_greedy_perm(S)
    return perm[new_parts], perm


@register_stage("host", "migrate", "metrics")
def _migrate_metrics_host(spec: BalanceSpec, old_parts, new_parts, weights):
    """Plan-level migration volume (TotalV/MaxV/retained), pad-masked."""
    p = spec.p
    valid = old_parts < p
    w = torch.where(valid, weights, 0.0)
    moved = (old_parts != new_parts) & valid
    moved_w = torch.where(moved, w, 0.0)
    outgoing = segment_sum_any_order(moved_w, old_parts, p,
                                     use_pallas=spec.use_pallas)
    incoming = segment_sum_any_order(moved_w, new_parts, p,
                                     use_pallas=spec.use_pallas)
    return {
        "total_v": moved_w.sum(),
        "max_v": torch.maximum(outgoing.max(), incoming.max()),
        "retained": torch.where(moved, 0.0, w).sum(),
    }


# ---------------------------------------------------------------------------
# Balancer facade
# ---------------------------------------------------------------------------

class Balancer:
    """Resolve a ``BalanceSpec`` into the balancing pipeline on a device.

    ``device=None`` means CUDA (for the sharded backend: ``comm``'s
    device); without a CUDA device it raises unless ``device="cpu"`` is
    passed.  ``balance`` applies the padding policy, runs the pipeline and
    truncates the parts to the caller's item count; ``balance_timed`` adds
    a blocking wall-clock measurement.

    ``backend='sharded'`` needs ``comm``, a ``distributed.Comm`` over a
    group of exactly ``p`` ranks, and every rank calls ``balance`` with
    the same global inputs (as the JAX package's single controller does):
    each rank runs the pipeline on its ``(C,)`` shard of the padded items
    and the result's ``parts`` are gathered, the same global array on
    every rank."""

    def __init__(self, spec: BalanceSpec, device=None, *, comm=None):
        self.spec = spec
        self.comm = comm
        self._variants = resolve_variants(spec)
        # previous call's splitters, threaded into the next ksection call
        # as warm-start boxes when spec.warm_start is set
        self._last_splitters: Optional[torch.Tensor] = None
        if spec.backend == "sharded":
            from ..distributed.stages import check_world
            check_world(spec, comm)
            if device is None:
                device = comm.device
        self.device = resolve_device(device)
        for stage in ("keys", "partition1d"):
            v = self._variants[stage]
            if v is not None:
                get_stage(spec.backend, stage, v)

    @classmethod
    def from_spec(cls, spec: BalanceSpec, *, device=None,
                  comm=None) -> "Balancer":
        """The reference's constructor name: ``Balancer(spec, device,
        comm=comm)`` (where the JAX package takes ``devices``, a
        sharded spec takes ``comm``)."""
        return cls(spec, device, comm=comm)

    # -- the pipeline ---------------------------------------------------------
    def balance_fn(self, weights, coords, old_parts=None, keys=None,
                   warm=None) -> BalanceResult:
        """The pipeline on already padded device tensors.  Sharded: this
        rank's ``(C,)`` shard in, this rank's shard of the parts out.
        Host: each stage in a span ``balance/<stage>`` (and the final
        part weights in ``balance/part_weights``), none of them blocking."""
        if self.spec.backend == "sharded":
            return self._sharded_apply(weights, coords, old_parts, keys, warm)
        spec = self.spec
        p = spec.p
        tr = telemetry.get_tracer()
        dev = weights.device
        kv = self._variants["keys"]
        with tr.span("balance/keys", allocator=dev):
            if keys is not None and kv is not None:
                k = get_stage("host", "keys", "cached")(spec, coords, weights,
                                                       keys=keys)
            else:
                k = (get_stage("host", "keys", kv)(spec, coords, weights)
                     if kv is not None else None)
        with tr.span("balance/partition1d", allocator=dev):
            out = get_stage("host", "partition1d",
                            self._variants["partition1d"])(
                spec, k, weights, coords, warm=warm)
        new, p1d_aux = out if isinstance(out, tuple) else (out, {})
        perm = torch.arange(p, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        total_v, max_v, retained = zero, zero, zero
        if old_parts is not None:
            if spec.use_remap:
                with tr.span("balance/remap", allocator=dev):
                    new, perm = get_stage("host", "remap", "greedy")(
                        spec, old_parts, new, weights)
            with tr.span("balance/migrate", allocator=dev):
                mv = get_stage("host", "migrate", "metrics")(
                    spec, old_parts, new, weights)
            total_v, max_v, retained = (mv["total_v"], mv["max_v"],
                                        mv["retained"])
        with tr.span("balance/part_weights", allocator=dev):
            pw = segment_sum_any_order(weights, new, p,
                                       use_pallas=spec.use_pallas)
            imbalance = _metrics.imbalance_of_part_weights(pw)
        return BalanceResult(parts=new, part_weights=pw,
                             imbalance=imbalance,
                             total_v=total_v, max_v=max_v, retained=retained,
                             remap_perm=perm, migration=None,
                             splitters=p1d_aux.get("splitters"),
                             ksection_rounds=p1d_aux.get("ksection_rounds"))

    def _sharded_apply(self, weights, coords, old_parts, keys=None,
                       warm=None) -> BalanceResult:
        from ..distributed.stages import build_balance_fn
        fn = build_balance_fn(self.spec, self.comm, old_parts is not None,
                              has_keys=keys is not None,
                              has_warm=warm is not None)
        opts = [x for x in (old_parts, keys, warm) if x is not None]
        parts, aux = fn(weights, coords, *opts)
        zero = torch.zeros((), dtype=torch.float32, device=weights.device)
        return BalanceResult(
            parts=parts, part_weights=aux["part_weights"],
            imbalance=aux["imbalance"],
            total_v=aux.get("total_v", zero), max_v=aux.get("max_v", zero),
            retained=aux.get("retained", zero),
            remap_perm=aux.get("remap_perm", torch.arange(
                self.spec.p, device=weights.device)),
            migration=aux.get("migration"),
            splitters=aux.get("splitters"),
            ksection_rounds=aux.get("ksection_rounds"))

    # -- padding policy -------------------------------------------------------
    def capacity_for(self, n: int) -> int:
        """Sharded per-rank capacity for an ``n``-item problem: the least
        power of two times ``min_capacity`` holding ``ceil(n / p)``."""
        per = -(-n // self.spec.p)
        C = self.spec.min_capacity
        while C < per:
            C <<= 1
        return C

    def _pad(self, weights, coords, old_parts, keys=None):
        spec = self.spec
        dev = self.device
        n = int(weights.shape[0])
        if coords is None and spec.method in SFC_METHODS + ("rcb",):
            raise ValueError(f"method {spec.method!r} requires coords")
        w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        if coords is None and spec.backend == "sharded":
            # sharded stages take a coords operand: arrival order
            coords = torch.stack([torch.arange(n, dtype=torch.float32),
                                  torch.zeros(n), torch.zeros(n)], dim=1)
        xyz = (None if coords is None
               else torch.as_tensor(coords, dtype=torch.float32, device=dev))
        old = None
        if old_parts is not None:
            if int(old_parts.shape[0]) != n:
                raise ValueError(
                    f"old_parts has {old_parts.shape[0]} items, weights "
                    f"{n}: after refinement, pass the inherited parts of "
                    "the *current* mesh")
            old = torch.as_tensor(old_parts, device=dev).long()
        ks = None
        if keys is not None:
            if self._variants["keys"] is None:
                raise ValueError(
                    f"method {spec.method!r} has no keys stage; "
                    "precomputed keys only apply to SFC/linear methods")
            if int(keys.shape[0]) != n:
                raise ValueError(
                    f"keys has {keys.shape[0]} items, weights {n}")
            if isinstance(keys, np.ndarray) and keys.dtype.kind == "u":
                keys = keys.astype(np.int64)     # uint32 keys: same values
            ks = torch.as_tensor(keys, device=dev)
        if spec.backend == "sharded":
            n_pad = spec.p * self.capacity_for(n)
        elif spec.padding == "pow2":
            n_pad = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
        else:
            n_pad = n
        if n_pad != n:
            extra = n_pad - n
            w = torch.cat([w, w.new_zeros(extra)])
            if xyz is not None:
                xyz = torch.cat([xyz, xyz[-1:].expand(extra, xyz.shape[1])])
            if old is not None:
                # padded items are invisible to the remap and migration
                old = torch.cat([old, old.new_full((extra,), spec.pad_part)])
            if ks is not None:
                # zero weight: the key only has to stay inside the box
                ks = torch.cat([ks, ks[-1:].expand(extra)])
        return w, xyz, old, ks, n

    # -- entry points ---------------------------------------------------------
    def balance(self, weights, *, coords=None, old_parts=None, keys=None,
                warm_splitters=None) -> BalanceResult:
        """Pad per policy, run the pipeline, truncate.

        Inputs may be numpy arrays or tensors on any device; they are
        moved to the balancer's device.  ``keys`` bypasses the keys stage
        with precomputed SFC keys.  ``warm_splitters`` seeds the k-section
        boxes; with ``spec.warm_start`` and none given, the previous
        call's splitters are used.  Sharded: every rank passes the same
        global inputs and gets the same global parts."""
        tr = telemetry.get_tracer()
        with tr.span("balance", block=True, allocator=self.device,
                     backend=self.spec.backend, method=self.spec.method,
                     oneD=self.spec.oneD) as sp:
            w, xyz, old, ks, n = self._pad(weights, coords, old_parts, keys)
            warm = warm_splitters
            if warm is None and self.spec.warm_start:
                warm = self._last_splitters
            if self._variants["partition1d"] != "ksection":
                warm = None
            if warm is not None:
                warm = torch.as_tensor(warm, dtype=torch.float32,
                                       device=self.device)
            if self.spec.backend == "sharded":
                res = self._balance_shard(w, xyz, old, ks, warm)
            else:
                res = self.balance_fn(w, xyz, old, ks, warm)
            if self.spec.warm_start and res.splitters is not None:
                self._last_splitters = res.splitters
            if int(res.parts.shape[0]) != n:
                res = dataclasses.replace(res, parts=res.parts[:n])
            sp.block_on(res.parts)
        if tr.enabled:
            self._publish_quality(tr, res)
        return res

    def _balance_shard(self, w, xyz, old, ks, warm) -> BalanceResult:
        """Run this rank's shard of the padded inputs; gather the parts."""
        r, C = self.comm.rank, w.shape[0] // self.spec.p
        mine = lambda x: None if x is None else x[r * C:(r + 1) * C]  # noqa
        res = self.balance_fn(mine(w), mine(xyz), mine(old), mine(ks), warm)
        return dataclasses.replace(res, parts=self.comm.all_gather(res.parts))

    def _publish_quality(self, tr, res: BalanceResult) -> None:
        """Publish the paper's partition-quality metrics for one call,
        the four scalars read from the device in one copy."""
        imbalance, total_v, max_v, retained = torch.stack(
            [res.imbalance, res.total_v, res.max_v, res.retained]).tolist()
        m = tr.metrics
        m.gauge("imbalance",
                help="max part weight / mean part weight").set(imbalance)
        m.counter("repartitions", help="balance() calls").inc()
        m.counter("migration_total_v", unit="weight",
                  help="paper TotalV: weight moved between parts").inc(
                      total_v)
        m.gauge("migration_max_v", unit="weight",
                help="paper MaxV: heaviest single-part inflow").set(max_v)
        m.counter("migration_retained", unit="weight",
                  help="weight that stayed on its part").inc(retained)

    def balance_timed(self, weights, *, coords=None, old_parts=None,
                      keys=None, warm_splitters=None
                      ) -> Tuple[BalanceResult, Dict[str, float]]:
        """``balance`` plus a wall-clock time that waits for the device."""
        with telemetry.stopwatch("balance_timed",
                                 backend=self.spec.backend) as sw:
            res = self.balance(weights, coords=coords, old_parts=old_parts,
                               keys=keys, warm_splitters=warm_splitters)
            sw.block_on(res.parts)
        return res, {"t_balance": sw.dur_s}


def compute_cut(parts, adjacency) -> torch.Tensor:
    """Communication proxy: element-adjacency links crossing parts.

    Companion metric kept outside ``BalanceResult`` (it needs the element
    graph, which the pipeline never sees)."""
    parts = torch.as_tensor(parts)
    return _metrics.cut_links(
        parts, torch.as_tensor(adjacency, device=parts.device).long())
