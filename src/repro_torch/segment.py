"""Segment sums with the JAX package's out-of-range semantics.

Two routes:

* ``segment_sum`` -- the FEM's sums (load vector, operator diagonal, mass
  matvec, the estimator's recovered gradient, the owned layout's halo
  finish).  On the card it adds each segment's contributions in an order
  fixed by the ids alone (``SegmentOrder``), so the same inputs give the
  same bits on every call, every run and every rank; ``index_add_`` on
  the card adds with atomics in a new order every time.  On the CPU it
  is ``index_add_``, which adds in input order, as the reference does.
  Where the ids stay fixed over many sums (a mesh's elements, a halo
  plan's rows), the caller builds their order once (``fixed_order``) and
  passes it to every sum: building one sorts the ids and reads one
  number back to the host.
* ``segment_sum_any_order`` -- for sums that are exact in any order: the
  balancer's, on the integer weights of the adaptive loop.  The
  hand-written kernel (``kernels.segment_sum``) on CUDA tensors,
  ``index_add_`` on CPU ones or with ``use_pallas=False``.
"""
from __future__ import annotations

from typing import Optional

import torch


def _in_fixed_order(x: torch.Tensor) -> bool:
    """Whether ``segment_sum`` takes the fixed-order route for ``x``."""
    return x.is_cuda


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                order: Optional["SegmentOrder"] = None) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` buckets by ``ids``.

    Ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them (the pad slot ``n_out`` of the
    element matvec, the pad slot ``V`` of the halo plan).  On CUDA
    tensors the order of additions is fixed by ``ids`` alone: ``order``,
    the ``SegmentOrder`` of these ids built once by the caller, or a new
    one built here.  On CPU tensors it is ``index_add_``'s input order
    and ``order`` is not read."""
    if _in_fixed_order(data):
        if order is None:
            order = SegmentOrder(ids, num_segments)
        elif order.num_segments != num_segments or order.n != ids.numel():
            raise ValueError(
                f"segment_sum: an order of {order.n} ids into "
                f"{order.num_segments} segments given for {ids.numel()} ids "
                f"into {num_segments}")
        return order.sum(data)
    return _index_add_sum(data, ids, num_segments)


def fixed_order(ids: torch.Tensor,
                num_segments: int) -> Optional["SegmentOrder"]:
    """The ``SegmentOrder`` that ``segment_sum`` would build for ``ids``
    on every call, built once here where it takes the fixed-order route
    (CUDA tensors); None where it does not, so callers keep one value
    either way and pass it as ``order``."""
    if _in_fixed_order(ids):
        return SegmentOrder(ids, num_segments)
    return None


def segment_sum_any_order(data: torch.Tensor, ids: torch.Tensor,
                          num_segments: int, *,
                          use_pallas: Optional[bool] = None) -> torch.Tensor:
    """``segment_sum`` in an order of additions that changes from call to
    call on the card, so only for sums exact in any order.  The
    hand-written kernel (``kernels.segment_sum.segment_sum_cuda``: (n,)
    float32 data, int32 or int64 ids) on CUDA tensors, ``index_add_`` on
    CPU ones or with ``use_pallas=False``; ``use_pallas`` has
    ``kernels.ops.use_kernel``'s meaning (True on CPU tensors raises).
    Out-of-range ids add nothing on either route."""
    from .kernels import ops
    if ops.use_kernel(data, use_pallas):
        from .kernels.segment_sum import segment_sum_cuda
        return segment_sum_cuda(data.contiguous(),
                                ids.reshape(-1).contiguous(), num_segments)
    return _index_add_sum(data, ids, num_segments)


def _index_add_sum(data: torch.Tensor, ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """The plain segment sum: ``index_add_``, which would raise on
    out-of-range ids, so they are masked to a zero contribution."""
    ids = ids.reshape(-1).long()
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    if num_segments == 0 or ids.numel() == 0:
        return out
    valid = (ids >= 0) & (ids < num_segments)
    rows = valid.view((-1,) + (1,) * (data.dim() - 1))
    return out.index_add_(0, torch.where(valid, ids, 0),
                          torch.where(rows, data, 0))


class SegmentOrder:
    """A fixed order of additions for the segment sums over one id array,
    built once and applied to any number of ``data`` arrays.

    The ids are sorted stably (dropped ids last), and each segment's run
    of sorted contributions is summed by a segmented Hillis-Steele scan:
    in step k every element adds the one 2^k places before it if that one
    lies in the same run, so after ceil(log2(longest run)) steps the last
    element of each run holds the run's sum.  The tree of additions
    depends only on each contribution's rank inside its run, so the bits
    depend on the ids and the data alone: not on timing, other segments or
    the device's scheduling.  Plain elementwise PyTorch (sort, gather,
    add): it runs on any device, the CPU tests included.  Building it
    reads the longest run back to the host (one synchronisation); ``sum``
    does not synchronise.  ``SegmentOrder.builds`` counts the orders
    built, so a run can show that a loop builds none."""

    #: orders built since the count was last set to 0
    builds = 0

    def __init__(self, ids: torch.Tensor, num_segments: int):
        SegmentOrder.builds += 1
        ids = ids.reshape(-1).long()
        self.num_segments = num_segments
        self.n = ids.numel()
        if num_segments == 0 or self.n == 0:
            return
        key = torch.where((ids >= 0) & (ids < num_segments), ids,
                          num_segments)
        sorted_key, self.order = torch.sort(key, stable=True)
        counts = torch.bincount(key, minlength=num_segments + 1)
        counts = counts[:num_segments]
        self.nonempty = counts > 0
        self.last = (torch.cumsum(counts, 0) - 1).clamp(min=0)
        longest = int(counts.max())
        # steps[k]: does sorted element i + 2^k share its run with i?
        self.steps = []
        shift = 1
        while shift < longest:
            self.steps.append((shift,
                               sorted_key[shift:] == sorted_key[:-shift]))
            shift *= 2

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        """(num_segments, *data.shape[1:]) segment sums of ``data`` (rows
        aligned with the ids)."""
        out_shape = (self.num_segments,) + tuple(data.shape[1:])
        if self.num_segments == 0 or self.n == 0:
            return data.new_zeros(out_shape)
        x = data.reshape((self.n,) + tuple(data.shape[1:]))[self.order]
        trail = (1,) * (x.dim() - 1)
        for shift, same in self.steps:
            add = torch.where(same.view((-1,) + trail), x[:-shift], 0)
            x = torch.cat([x[:shift], x[shift:] + add])
        sums = x[self.last]
        return torch.where(self.nonempty.view((-1,) + trail), sums, 0)
