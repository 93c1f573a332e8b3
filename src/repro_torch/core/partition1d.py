"""Weighted 1-D partitioning (paper section 2.3), host / single-device form.

* ``ksection``     -- the paper's search: split each splitter's box into
  k candidate cuts, measure the weight below every cut with one
  histogram, shrink the boxes, repeat.  The histogram is the only piece
  that touches the items (``hist_fn``; on CUDA tensors the hand-written
  kernel through ``kernels.ops.ksection_histogram_op``).
* ``sorted_exact`` -- sort once, exclusive prefix sum of the sorted
  weights (Algorithm 1's S_i, through ``kernels.ops.exclusive_scan_op``:
  the hand-written scan kernel on CUDA tensors), part = floor(S_i * p / W).
* ``distributed_prefix_parts`` -- the same over a process group: a local
  scan plus one ``exclusive_scan_over_axis`` (the paper's MPI_Scan).

Counterpart of ``repro.core.partition1d``: the same float32 arithmetic in
the same order, so parts and splitters match it exactly on integer
weights.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import telemetry
from ..segment import segment_sum_any_order


class Partition1DResult(NamedTuple):
    parts: torch.Tensor         # (n,) int64 part id per item
    splitters: torch.Tensor     # (p-1,) float32 key-space cut points
    part_weights: torch.Tensor  # (p,) weight per part
    rounds: Optional[int] = None  # k-section rounds actually run


# ---------------------------------------------------------------------------
# Exact prefix-sum partition (Algorithm 1 applied to sorted keys)
# ---------------------------------------------------------------------------

def _parts_of_prefix(s: torch.Tensor, total: torch.Tensor,
                     p: int) -> torch.Tensor:
    total = torch.where(total <= 0, torch.ones_like(total), total)
    parts = torch.floor(s * p / total).to(torch.int64)
    return parts.clamp(0, p - 1)


def prefix_sum_parts(weights_in_order: torch.Tensor, p: int, *,
                     use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Paper eq. (1)/(2): item with exclusive prefix sum S_i goes to part j
    iff S_i in [W*j/p, W*(j+1)/p).  Weights already in linearized order.
    float32, ``s * p / total`` in that order (the JAX package's).  S_i
    comes from ``exclusive_scan_op``; every order of additions is exact
    on integer weights below 2^24, so the parts equal the JAX package's
    ``cumsum`` ones there."""
    from ..kernels import ops
    w = weights_in_order.to(torch.float32)
    s = ops.exclusive_scan_op(w, use_pallas=use_pallas)
    return _parts_of_prefix(s, w.sum(), p)


def sorted_exact(keys: torch.Tensor, weights: torch.Tensor, p: int, *,
                 use_pallas: Optional[bool] = None) -> Partition1DResult:
    """Exact 1-D partition: stable sort + prefix-sum slice."""
    order = torch.argsort(keys, stable=True)
    parts_sorted = prefix_sum_parts(weights[order], p, use_pallas=use_pallas)
    parts = torch.empty_like(parts_sorted)
    parts[order] = parts_sorted
    part_weights = segment_sum_any_order(weights, parts, p,
                                         use_pallas=use_pallas)
    ksorted = keys[order].to(torch.float32)
    # a_j = key of the first item assigned to parts >= j, or max_key + 1
    # when every item lies below part j (an empty part collapses onto the
    # next boundary: duplicated but monotone)
    n = keys.shape[0]
    idx = torch.searchsorted(parts_sorted,
                             torch.arange(1, p, device=keys.device))
    past_end = ksorted[n - 1] + 1.0
    splitters = torch.where(idx < n, ksorted[idx.clamp(max=n - 1)], past_end)
    return Partition1DResult(parts, torch.sort(splitters).values, part_weights)


# ---------------------------------------------------------------------------
# k-section search
# ---------------------------------------------------------------------------

def weight_below(keys: torch.Tensor, weights: torch.Tensor,
                 cuts: torch.Tensor) -> torch.Tensor:
    """Total weight of items with key < cut, for cuts in ANY order.

    searchsorted of every key among the sorted cuts + ``index_add_`` into
    m + 1 buckets + cumsum, restored to the caller's cut order: the plain
    version of the k-section histogram kernel."""
    order = torch.argsort(cuts, stable=True)
    cs = cuts[order].contiguous()
    bucket = torch.searchsorted(cs, keys.to(cs.dtype).contiguous(), right=True)
    m = cuts.shape[0]
    hist = torch.zeros(m + 1, dtype=weights.dtype, device=weights.device)
    hist.index_add_(0, bucket, weights)
    below = torch.cumsum(hist, dim=0)[:-1]
    out = torch.empty_like(below)
    out[order] = below
    return out


def _fma_f32(width: torch.Tensor, frac: torch.Tensor,
             blo: torch.Tensor) -> torch.Tensor:
    """Candidate cuts ``blo + width * frac`` (boxes x fractions) rounded
    once, as a fused multiply-add: XLA contracts the JAX package's
    expression into an FMA, and the candidates decide the splitters.
    The product of two float32 values is exact in float64, so the float64
    sum rounded to float32 is the FMA (barring a double rounding, which
    needs the float64 result to fall exactly on a float32 midpoint)."""
    f64 = torch.float64
    return (blo.to(f64)[:, None]
            + width.to(f64)[:, None] * frac.to(f64)[None, :]).to(torch.float32)


def ksection_splitters_counted(
        targets: torch.Tensor, blo: torch.Tensor, bhi: torch.Tensor,
        hist_fn: Callable[[torch.Tensor], torch.Tensor], *,
        k: int, iters: int, tol: float = 0.0) -> Tuple[torch.Tensor, int]:
    """The k-section box-shrinking search.

    Each round subdivides every box [blo_i, bhi_i] into k candidate cuts,
    measures the weight below all (p-1)*k of them with one ``hist_fn``
    call, and shrinks each box to the subinterval bracketing its target.
    Stops after ``iters`` rounds or once no box is both wider than
    ``tol`` and still shrinking (float32 resolution).  The splitter is
    the lower bound of each converged box.  Returns ``(splitters,
    rounds)``; the loop condition is checked on the host each round.

    Traced: ``ksection/sync`` around each check of the loop condition,
    and ``ksection/round`` (attribute ``round``) around each round the
    check lets run.  The loop keeps its untraced shape: every tensor
    lives as long as it does without spans, so the caching allocator
    places the next repartition's blocks where it would untraced."""
    fdt = targets.dtype
    q = targets.shape[0]
    frac = torch.arange(1, k + 1, dtype=fdt, device=targets.device) / (k + 1)
    tr = telemetry.get_tracer()
    prev_w = torch.full_like(targets, float("inf"))
    rounds = 0
    while rounds < iters:
        width = bhi - blo
        working = (width > tol) & (width < prev_w)
        with tr.span("ksection/sync"):
            tr.count("host_syncs")
            go = bool(working.any())
        if not go:
            break
        with tr.span("ksection/round", round=rounds):
            cand = _fma_f32(bhi - blo, frac, blo)
            below = hist_fn(cand.reshape(-1)).reshape(q, k)
            le = below <= targets[:, None]
            new_lo = torch.where(
                le.any(dim=1),
                torch.where(le, cand, float("-inf")).amax(dim=1), blo)
            gt = ~le
            new_hi = torch.where(
                gt.any(dim=1),
                torch.where(gt, cand, float("inf")).amin(dim=1), bhi)
            prev_w = bhi - blo
            blo, bhi = torch.maximum(new_lo, blo), torch.minimum(new_hi, bhi)
        rounds += 1
    return torch.sort(blo).values, rounds


def ksection_splitters(targets: torch.Tensor, blo: torch.Tensor,
                       bhi: torch.Tensor, hist_fn: Callable, *, k: int,
                       iters: int, tol: float = 0.0) -> torch.Tensor:
    """Splitters-only wrapper of :func:`ksection_splitters_counted`."""
    return ksection_splitters_counted(
        targets, blo, bhi, hist_fn, k=k, iters=iters, tol=tol)[0]


def warm_start_boxes(prev, lo, hi, targets: torch.Tensor, hist_fn, *,
                     k: int = 8, tight_frac: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search boxes seeded from the previous step's splitters.

    Two candidate boxes per splitter, narrowest valid wins: tight
    (prev_i +- tight_frac * neighbour gap) and neighbour
    ([prev_{i-1}, prev_{i+1}]).  One extra ``hist_fn`` call evaluates F
    at all four edges; a box is valid iff F(blo) <= target < F(bhi).
    Invalid boxes reset to the full range [lo, hi]."""
    fdt, dev = targets.dtype, targets.device
    prev = torch.sort(torch.as_tensor(prev, dtype=fdt, device=dev)).values
    lo = torch.as_tensor(lo, dtype=fdt, device=dev)
    hi = torch.as_tensor(hi, dtype=fdt, device=dev)
    if tight_frac is None:
        tight_frac = 1.0 / ((k + 1) ** 2)
    nlo = torch.clamp(torch.cat([lo[None], prev[:-1]]), lo, hi)
    nhi = torch.clamp(torch.cat([prev[1:], hi[None]]), lo, hi)
    # a blocking copy from the host: the host waits for the stream
    telemetry.get_tracer().count("host_syncs")
    m = (nhi - nlo) * torch.tensor(tight_frac, dtype=fdt, device=dev)
    tlo = torch.clamp(prev - m, lo, hi)
    thi = torch.clamp(prev + m, lo, hi)
    q = prev.shape[0]
    below = hist_fn(torch.cat([tlo, thi, nlo, nhi]))
    f_tlo, f_thi = below[:q], below[q:2 * q]
    f_nlo, f_nhi = below[2 * q:3 * q], below[3 * q:]
    t_ok = (thi > tlo) & (f_tlo <= targets) & (f_thi > targets)
    n_ok = (nhi > nlo) & (f_nlo <= targets) & (f_nhi > targets)
    blo = torch.where(t_ok, tlo, torch.where(n_ok, nlo, lo))
    bhi = torch.where(t_ok, thi, torch.where(n_ok, nhi, hi))
    return blo, bhi


def ksection(keys: torch.Tensor, weights: torch.Tensor, p: int, *,
             k: int = 8, iters: int = 12, lo=None, hi=None, hist_fn=None,
             warm=None, tol: float = 0.0,
             use_pallas: Optional[bool] = None) -> Partition1DResult:
    """The paper's 1-D partitioner.

    ``hist_fn(keys, weights, cuts) -> below`` overrides the per-round
    histogram; the default is ``kernels.ops.ksection_histogram_op`` with
    ``use_pallas`` (the hand-written kernel on CUDA tensors, the plain
    ``weight_below`` on CPU ones).  ``warm`` seeds the boxes from a
    previous step's (p-1,) splitters.  Keys are cast to float32, as in
    the JAX package (neighbouring 30-bit keys may collide).  Traced:
    ``ksection/warm_start`` (the extra histogram call), the rounds, and
    ``ksection/assign`` (the parts and their weights)."""
    fdt = torch.float32
    dev = keys.device
    kf = keys.to(fdt)
    w = weights.to(fdt)
    total = w.sum()
    targets = total * torch.arange(1, p, dtype=fdt, device=dev) / p
    lo_s = kf.min() if lo is None else torch.as_tensor(lo, dtype=fdt, device=dev)
    hi_s = kf.max() + 1 if hi is None else torch.as_tensor(hi, dtype=fdt,
                                                           device=dev)
    if hist_fn is None:
        from ..kernels import ops
        hist_fn = functools.partial(ops.ksection_histogram_op,
                                    use_pallas=use_pallas)
    hfn = lambda cuts: hist_fn(kf, w, cuts)  # noqa: E731
    tr = telemetry.get_tracer()
    if warm is not None:
        with tr.span("ksection/warm_start"):
            blo, bhi = warm_start_boxes(warm, lo_s, hi_s, targets, hfn, k=k)
    else:
        blo = lo_s.expand(p - 1).clone()
        bhi = hi_s.expand(p - 1).clone()
    splitters, rounds = ksection_splitters_counted(
        targets, blo, bhi, hfn, k=k, iters=iters, tol=tol)
    with tr.span("ksection/assign"):
        parts = torch.searchsorted(splitters.contiguous(), kf.contiguous(),
                                   right=True)
        part_weights = segment_sum_any_order(w, parts, p,
                                             use_pallas=use_pallas)
    return Partition1DResult(parts, splitters, part_weights, rounds)


# ---------------------------------------------------------------------------
# Distributed helper: the MPI_Scan step of Algorithm 1 over a process group
# ---------------------------------------------------------------------------

def exclusive_scan_over_axis(local_sum: torch.Tensor, comm) -> torch.Tensor:
    """Exclusive prefix sum of per-rank totals across the group.

    The paper's single ``MPI_Scan``: every rank learns the total weight
    owned by lower ranks.  One ``all_gather`` of the p scalars and a
    masked sum, as the JAX package does it -- O(p) data, one collective."""
    local_sum = torch.as_tensor(local_sum)
    sums = comm.all_gather(local_sum.reshape((1,) + tuple(local_sum.shape)))
    mask = torch.arange(comm.size, device=sums.device) < comm.rank
    mask = mask.reshape((comm.size,) + (1,) * local_sum.dim())
    return torch.where(mask, sums, torch.zeros_like(sums)).sum(dim=0)


def distributed_prefix_parts(local_weights: torch.Tensor, p: int, comm, *,
                             use_pallas: Optional[bool] = None
                             ) -> torch.Tensor:
    """Algorithm 1 over a process group: two local passes and one scan
    collective.  ``local_weights`` are this rank's weights in curve / DFS
    order (the ranks' arrays in rank order give the global order);
    returns the part id of each local item.  The local scan is
    ``exclusive_scan_op`` (the hand-written kernel on CUDA tensors)."""
    from ..kernels import ops
    w = local_weights.to(torch.float32)
    local_sum = w.sum()                                     # traversal 1
    offset = exclusive_scan_over_axis(local_sum, comm)      # MPI_Scan
    total = comm.psum(local_sum)
    s = offset + ops.exclusive_scan_op(w, use_pallas=use_pallas)  # 2
    return _parts_of_prefix(s, total, p)
