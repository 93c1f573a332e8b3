"""Sharded stage implementations for the ``BalanceSpec`` registry.

Each stage is the rank-local body of one pipeline step: every rank of a
process group runs it on its own ``(C,)`` shard, and the collectives of
``distributed.comm.Comm`` join the shards.  ``build_balance_fn`` composes
the registered stages for a spec.  Counterpart of
``repro.distributed.stages``, where the same bodies run inside one
``shard_map`` region over a device mesh.

Stage parity contract: every sharded stage computes the *same values* as
its host counterpart -- bit-exact on integer-valued weights -- because
collectives only reorder exact additions:

* keys        global bounding box by pmin/pmax instead of a host min/max;
              the SFC-key kernel per rank
* sorted      replicated all-gather argsort + Algorithm-1 partition (the
              local scan is the prefix-scan kernel, the MPI_Scan one
              all-gather of p scalars)
* ksection    the paper's histogram search, with the per-round
              weight-below histogram reduced by one psum of size
              ``(p-1)*k``.  'ksection' takes the histogram through
              ``kernels.ops`` with the spec's ``use_pallas`` (the kernel
              on CUDA tensors), 'ksection_pallas' always runs the kernel
              (``use_pallas=True``)
* remap       psum of per-rank similarity rows + redundant greedy solve
* migrate     plan metrics, plus the all_to_all payload executor
"""
from __future__ import annotations

import torch

from ..core import metrics as _metrics
from ..core import partition1d as _p1d
from ..core import sfc as _sfc
from ..core.remap import guarded_greedy_perm, similarity_matrix
from ..core.spec import BalanceSpec, get_stage, register_stage, resolve_variants
from ..segment import segment_sum
from .migrate import migrate_items


def check_world(spec: BalanceSpec, comm) -> None:
    """The number of parts is the number of ranks, as the JAX package's
    mesh has one device per part."""
    if comm is None:
        raise ValueError("backend='sharded' needs a process group: pass "
                         "comm=distributed.Comm(...) (p ranks, one per part)")
    if comm.size != spec.p:
        raise ValueError(f"backend='sharded' runs one rank per part: "
                         f"p={spec.p}, world size {comm.size}")


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

@register_stage("sharded", "keys", "sfc")
def _keys_sfc_sharded(spec: BalanceSpec, coords, weights, *, comm):
    from ..kernels.ops import sfc_keys_op
    lo = comm.pmin(coords.amin(dim=0))
    hi = comm.pmax(coords.amax(dim=0))
    grid = _sfc.box_map(coords, lo, hi, uniform=spec.method != "hsfc_zoltan",
                        bits=spec.sfc_bits)
    curve = "morton" if spec.method == "msfc" else "hilbert"
    return sfc_keys_op(grid, curve=curve, bits=spec.sfc_bits,
                       use_pallas=spec.use_pallas)


@register_stage("sharded", "keys", "linear")
def _keys_linear_sharded(spec: BalanceSpec, coords, weights, *, comm):
    # the Balancer synthesizes arrival-order coords when none are given
    return coords[:, 0]


@register_stage("sharded", "keys", "cached")
def _keys_cached_sharded(spec: BalanceSpec, coords, weights, *, comm, keys):
    """Pass-through for precomputed keys (the incremental ``KeyCache``
    path): the bounding-box reduction is skipped."""
    return keys


# ---------------------------------------------------------------------------
# partition1d
# ---------------------------------------------------------------------------

@register_stage("sharded", "partition1d", "sorted")
def _partition_sorted_sharded(spec: BalanceSpec, keys, weights, coords, *,
                              comm, warm=None):
    """Replicated global curve order + Algorithm-1 scan partition."""
    p, rank = spec.p, comm.rank
    C = keys.shape[0]
    keys_g = comm.all_gather(keys)
    w_g = comm.all_gather(weights)
    order = torch.argsort(keys_g, stable=True)
    w_sorted_local = w_g[order][rank * C:(rank + 1) * C]
    parts_sorted = _p1d.distributed_prefix_parts(
        w_sorted_local, p, comm, use_pallas=spec.use_pallas)
    parts_sorted_g = comm.all_gather(parts_sorted)
    parts_g = torch.empty_like(parts_sorted_g)
    parts_g[order] = parts_sorted_g
    return parts_g[rank * C:(rank + 1) * C]


def ksection_splitters_sharded(spec: BalanceSpec, kf, w, *, comm,
                               hist_local, warm=None):
    """The distributed k-section search: the iteration of
    ``core.partition1d.ksection`` (``ksection_splitters_counted`` is the
    same function), with the only collective ONE psum of the ``(p-1)*k``
    candidate-cut histogram per round.  ``warm`` (replicated (p-1,)
    splitters) seeds the boxes.  Returns ``(splitters, rounds)``."""
    p = spec.p
    fdt = torch.float32
    total = comm.psum(w.sum())
    targets = total * torch.arange(1, p, dtype=fdt, device=w.device) / p
    hist = lambda cuts: comm.psum(hist_local(cuts))  # noqa: E731
    lo = comm.pmin(kf.min())
    hi = comm.pmax(kf.max()) + 1
    if warm is not None:
        blo, bhi = _p1d.warm_start_boxes(warm, lo, hi, targets, hist,
                                         k=spec.k)
    else:
        blo = lo.expand(p - 1).clone()
        bhi = hi.expand(p - 1).clone()
    return _p1d.ksection_splitters_counted(
        targets, blo, bhi, hist, k=spec.k, iters=spec.iters,
        tol=spec.ksection_tol)


def _ksection_parts(spec: BalanceSpec, keys, weights, *, comm, use_pallas,
                    warm=None):
    from ..kernels.ops import ksection_histogram_op
    kf = keys.to(torch.float32)
    w = weights.to(torch.float32)
    splitters, rounds = ksection_splitters_sharded(
        spec, kf, w, comm=comm, warm=warm,
        hist_local=lambda cuts: ksection_histogram_op(
            kf, w, cuts, use_pallas=use_pallas))
    parts = torch.searchsorted(splitters.contiguous(), kf.contiguous(),
                               right=True)
    return parts, {"splitters": splitters, "ksection_rounds": rounds}


@register_stage("sharded", "partition1d", "ksection")
def _partition_ksection_sharded(spec: BalanceSpec, keys, weights, coords, *,
                                comm, warm=None):
    """The paper's k-section histogram search, distributed."""
    return _ksection_parts(spec, keys, weights, comm=comm, warm=warm,
                           use_pallas=spec.use_pallas)


@register_stage("sharded", "partition1d", "ksection_pallas")
def _partition_ksection_pallas_sharded(spec: BalanceSpec, keys, weights,
                                       coords, *, comm, warm=None):
    """The same search with the histogram kernel forced
    (``BalanceSpec(use_pallas=True)``: CUDA tensors only)."""
    return _ksection_parts(spec, keys, weights, comm=comm, warm=warm,
                           use_pallas=True)


# ---------------------------------------------------------------------------
# remap
# ---------------------------------------------------------------------------

@register_stage("sharded", "remap", "greedy")
def _remap_greedy_sharded(spec: BalanceSpec, old_parts, new_parts, weights,
                          *, comm):
    """Distributed Oliker--Biswas: each rank scores its own items, the
    p x p similarity is one psum, the greedy assignment is solved on
    every rank.  Padded old parts fall outside the ``p*p`` segments."""
    p = spec.p
    S = comm.psum(similarity_matrix(old_parts, new_parts, weights, p, p))
    perm = guarded_greedy_perm(S)
    return perm[new_parts], perm


# ---------------------------------------------------------------------------
# migrate
# ---------------------------------------------------------------------------

@register_stage("sharded", "migrate", "metrics")
def _migrate_metrics_sharded(spec: BalanceSpec, old_parts, new_parts,
                             weights, *, comm):
    p = spec.p
    valid = old_parts < p
    w = torch.where(valid, weights, 0.0)
    moved = torch.where((old_parts != new_parts) & valid, w, 0.0)
    outgoing = comm.psum(segment_sum(moved, old_parts, p))
    incoming = comm.psum(segment_sum(moved, new_parts, p))
    return {
        "total_v": outgoing.sum(),
        "max_v": torch.maximum(outgoing.max(), incoming.max()),
        "retained": comm.psum(
            torch.where((old_parts == new_parts) & valid, w, 0.0).sum()),
    }


@register_stage("sharded", "migrate", "all_to_all")
def _migrate_executor_sharded(spec: BalanceSpec, old_parts, new_parts,
                              weights, *, comm):
    """Ship the weight payload old -> new owner with one all_to_all and
    return the conservation scalars (equal on every rank)."""
    p = spec.p
    valid = old_parts < p
    w = torch.where(valid, weights, 0.0)
    mig = migrate_items({"w": w}, new_parts, w, comm, p, valid=valid)
    return {
        "weight_in": comm.psum(mig.weights.sum()),
        "weight_out": comm.psum(w.sum()),
        "items": comm.psum(mig.n_recv),
        "overflow": comm.psum(mig.overflow),
    }


# ---------------------------------------------------------------------------
# pipeline composition
# ---------------------------------------------------------------------------

def build_balance_fn(spec: BalanceSpec, comm, has_old: bool,
                     has_keys: bool = False, has_warm: bool = False):
    """Compose the registered sharded stages into this rank's pipeline.

    Returns ``fn(weights, coords, *opts) -> (parts, aux)`` over this
    rank's ``(C,)`` shard (``coords`` (C, 3)); ``opts`` are -- in order,
    each present only when its flag is set -- ``old_parts`` (this rank's
    shard), precomputed ``keys`` (this rank's shard) and ``warm``
    splitters (replicated (p-1,)).  ``parts`` is this rank's shard of the
    new partition; every entry of ``aux`` is equal on every rank."""
    check_world(spec, comm)
    variants = resolve_variants(spec)
    p1d_variant = variants["partition1d"]
    if p1d_variant == "ksection" and spec.use_pallas:
        p1d_variant = "ksection_pallas"
    keys_fn = (get_stage("sharded", "keys", variants["keys"])
               if variants["keys"] is not None else None)
    p1d_fn = get_stage("sharded", "partition1d", p1d_variant)
    p = spec.p
    if has_keys and keys_fn is None:
        raise ValueError(
            f"method {spec.method!r} has no keys stage; precomputed keys "
            "only apply to SFC/linear methods")

    def body(w, xyz, old=None, keys_in=None, warm=None):
        if keys_in is not None:
            keys = get_stage("sharded", "keys", "cached")(
                spec, xyz, w, comm=comm, keys=keys_in)
        else:
            keys = keys_fn(spec, xyz, w, comm=comm)
        out = p1d_fn(spec, keys, w, xyz, comm=comm, warm=warm)
        new, aux = out if isinstance(out, tuple) else (out, {})
        if old is not None and spec.use_remap:
            new, perm = get_stage("sharded", "remap", "greedy")(
                spec, old, new, w, comm=comm)
            aux["remap_perm"] = perm
        valid_w = torch.where(old < p, w, 0.0) if old is not None else w
        pw = comm.psum(segment_sum(valid_w, new, p))
        aux["part_weights"] = pw
        aux["imbalance"] = _metrics.imbalance_of_part_weights(pw)
        if old is not None:
            aux.update(get_stage("sharded", "migrate", "metrics")(
                spec, old, new, w, comm=comm))
            if spec.execute_migration:
                aux["migration"] = get_stage(
                    "sharded", "migrate", "all_to_all")(
                        spec, old, new, w, comm=comm)
        return new, aux

    slots = (has_old, has_keys, has_warm)

    def fn(w, xyz, *rest):
        rest = list(rest)
        opts = [rest.pop(0) if flag else None for flag in slots]
        if rest:
            raise TypeError(f"balance fn: {len(rest)} operands too many")
        return body(w, xyz, *opts)

    return fn

