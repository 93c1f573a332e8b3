"""Distributed matrix-free FEM operator over a process group.

The compute model of the paper (section 1): each rank owns the sub-mesh
the balancer assigned to it and computes element-local work; the global
vertex reduction is the inter-process communication.  Counterpart of
``repro.fem.parallel``, whose ``(p, C, ...)`` packing lives here as one
``(C, ...)`` row per rank (``ShardedElements``; the rows in rank order
are the JAX package's arrays).

Element distribution:

* ``shard_elements``           host packing of this rank's row -- the
                               control-plane path for tests and setup;
* ``shard_elements_on_device`` the production path: element payloads
                               move between ranks with the migration
                               executor's ``all_to_all``;
                               ``reshard_elements`` composes it with the
                               sharded ``Balancer``.

Two vertex layouts:

* ``"replicated"``  the vertex vector is (n_verts,) on every rank and the
                    reduction is one ``psum`` -- O(n_verts) wire traffic
                    per matvec regardless of partition quality;
* ``"owned"``       vertices are sharded by owner part (``fem.halo``):
                    vectors are (V,) per rank with locally renumbered
                    connectivity, and the reduction is
                    ``halo.halo_reduce`` -- two neighbour ``all_to_all``
                    legs whose volume follows the partition's cut.

Every per-rank element pass is the element-matvec kernel
(``kernels.ops.ElementOperator`` on element matrices and kernel plans
built once per packing; its plain version on CPU tensors).  Owned
packings are interface-first (``n_interface``), so the owned matvec
computes the interface elements, starts the first halo leg, computes the
interior elements while it is in flight, and then finishes the exchange.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.fem_matvec import fem_element_matrices
from ..segment import SegmentOrder, fixed_order, segment_sum
from .assemble import _mass, P1Elements
from .halo import (HaloPlan, build_halo_plan, halo_finish, halo_reduce,
                   halo_start)
from .solve import CGResult, owned_vdot, pcg

VERTEX_LAYOUTS = ("replicated", "owned")


class ShardedElements(NamedTuple):
    """This rank's row of the per-part element packing.

    ``layout="replicated"``: ``tets`` holds global vertex ids (padding 0,
    vol 0 makes padded elements no-ops).  ``layout="owned"``: ``tets``
    holds part-local slot ids into the ``halo`` plan's (V,) layout
    (padding ``halo.V``, dropped by the local scatter), packed
    interface-first: the row leads with the elements that touch a shared
    vertex, and ``n_interface`` (the max per-part interface count, equal
    on every rank) is the split point.  ``order``: the fixed order of
    the sums over ``tets`` into the layout's vertex slots (``n_verts``
    replicated, ``halo.V`` owned), built once by the packers on the card
    (``segment.fixed_order``), None elsewhere."""
    tets: torch.Tensor    # (C, 4) int32
    grads: torch.Tensor   # (C, 4, 3)
    vol: torch.Tensor     # (C,)  (0 on padding -> padded elements are no-ops)
    n_verts: int
    p: int
    rank: int
    halo: Optional[HaloPlan] = None
    layout: str = "replicated"
    n_interface: Optional[int] = None
    order: Optional[SegmentOrder] = None


def _resolve_layout(sel: ShardedElements, vertex_layout: Optional[str]) -> str:
    layout = sel.layout if vertex_layout is None else vertex_layout
    if layout not in VERTEX_LAYOUTS:
        raise ValueError(f"unknown vertex_layout {layout!r}; "
                         f"choose from {VERTEX_LAYOUTS}")
    if layout != sel.layout:
        raise ValueError(
            f"vertex_layout={layout!r} needs elements packed with that "
            f"layout (got layout={sel.layout!r}; pass halo= to the packer)")
    if layout == "owned" and sel.halo is None:
        raise ValueError("owned layout needs a HaloPlan on the packing")
    return layout


def shard_elements(el: P1Elements, parts: np.ndarray, p: int,
                   halo: Optional[HaloPlan] = None, *, rank: int
                   ) -> ShardedElements:
    """Pack rank ``rank``'s element list, padded to the max part size.

    With ``halo`` given, connectivity is renumbered to part-local slots
    (owned layout), padding rows point at slot ``halo.V``, and the row
    is packed interface-first with the split point ``n_interface``."""
    parts = np.asarray(parts)
    tets = el.tets.cpu().numpy()
    dev = el.grads.device
    counts = np.bincount(parts, minlength=p)
    C = int(counts.max())
    pad_vert = 0 if halo is None else halo.V
    st = np.full((C, 4), pad_vert, np.int32)
    idx = np.flatnonzero(parts == rank)
    n_interface = None
    if halo is not None:
        iface = halo.shared_vertex_mask()[tets].any(axis=1)
        n_interface = int(np.bincount(parts[iface], minlength=p).max())
        f = iface[idx]
        idx = np.concatenate([idx[f], idx[~f]])        # interface first
    t = tets[idx]
    st[:idx.size] = t if halo is None else halo.global_to_local[rank][t]
    rows = torch.as_tensor(idx, device=dev)
    sg = el.grads.new_zeros((C, 4, 3))
    sv = el.vol.new_zeros((C,))
    sg[:idx.size] = el.grads[rows]
    sv[:idx.size] = el.vol[rows]
    st = torch.as_tensor(st, device=dev)
    return ShardedElements(st, sg, sv, el.n_verts, p, rank, halo=halo,
                           layout="replicated" if halo is None else "owned",
                           n_interface=n_interface,
                           order=_packing_order(st, el.n_verts, halo))


def shard_elements_on_device(el: P1Elements, parts, p: int, comm,
                             halo: Optional[HaloPlan] = None
                             ) -> ShardedElements:
    """Pack this rank's element list with the migration executor.

    Elements start index-sharded (rank r holds global rows [rC, (r+1)C) of
    the replicated element arrays); one ``all_to_all`` per payload leaf
    delivers each element's connectivity, gradients and volume to the
    rank the partition assigned it.  The receive capacity is the largest
    part (the same quantity the host packer sizes its arrays by), so
    nothing overflows.  Padding rows keep vol = 0.

    With ``halo`` given, an interface flag per element (does it touch a
    shared vertex) rides along; a stable sort on arrival puts interface
    elements first, and the received connectivity is renumbered to
    part-local slots (padding -> slot ``halo.V``)."""
    from ..distributed.migrate import migrate_items
    parts_h = np.asarray(parts)
    n = int(parts_h.shape[0])
    r = comm.rank
    C_in = -(-n // p)
    cap = int(np.bincount(parts_h, minlength=p).max())
    dev = el.grads.device
    lo, hi = min(r * C_in, n), min((r + 1) * C_in, n)

    def mine(a: torch.Tensor) -> torch.Tensor:
        a = a[lo:hi]
        if hi - lo == C_in:
            return a
        return torch.cat([a, a.new_zeros((C_in - (hi - lo),) + a.shape[1:])])

    dest = mine(torch.as_tensor(parts_h, device=dev))
    valid = torch.arange(C_in, device=dev) < hi - lo
    payload = {"tets": mine(el.tets), "grads": mine(el.grads),
               "vol": mine(el.vol)}
    n_interface = None
    if halo is not None:
        iface_h = halo.shared_vertex_mask()[el.tets.cpu().numpy()].any(axis=1)
        n_interface = int(np.bincount(parts_h[iface_h], minlength=p).max())
        payload["iface"] = mine(torch.as_tensor(iface_h.astype(np.int32),
                                                device=dev))
    mig = migrate_items(payload, dest, payload["vol"], comm, p, valid=valid,
                        capacity=cap)
    t, g, v = mig.payload["tets"], mig.payload["grads"], mig.payload["vol"]
    val = mig.valid
    if halo is None:
        t = torch.where(val[:, None], t, 0)
    else:
        # interface-first: stable sort on (0 interface, 1 interior,
        # 2 padding) keeps arrival order inside each class
        key = torch.where(val, torch.where(mig.payload["iface"] > 0, 0, 1), 2)
        order = torch.argsort(key, stable=True)
        t, g, v, val = t[order], g[order], v[order], val[order]
        g2l = torch.as_tensor(halo.global_to_local[r], device=dev)
        t = g2l[t.long().clamp(max=halo.n_verts - 1)]
        t = torch.where(val[:, None], t, halo.V)
    g = torch.where(val[:, None, None], g, 0.0)
    v = torch.where(val, v, 0.0)
    t = t.to(torch.int32).contiguous()
    return ShardedElements(t, g, v, el.n_verts, p, r, halo=halo,
                           layout="replicated" if halo is None else "owned",
                           n_interface=n_interface,
                           order=_packing_order(t, el.n_verts, halo))


def _packing_order(tets: torch.Tensor, n_verts: int,
                   halo: Optional[HaloPlan]) -> Optional[SegmentOrder]:
    """The fixed order of a packing's sums over its slots (None off the
    card)."""
    return fixed_order(tets.reshape(-1), n_verts if halo is None else halo.V)


def reshard_elements(el: P1Elements, coords, p: int, comm, *,
                     old_parts=None, balancer=None, spec=None,
                     vertex_layout: str = "replicated"):
    """One full DLB step for the FEM layer: the sharded ``Balancer``
    (partition + remap over the group), then element migration with the
    ``all_to_all`` executor.  Returns ``(ShardedElements, result)``.
    ``vertex_layout="owned"`` also builds the halo plan from the fresh
    partition and packs locally renumbered connectivity.  In a loop, pass
    a persistent ``balancer``."""
    from ..core.spec import Balancer, BalanceSpec
    if vertex_layout not in VERTEX_LAYOUTS:
        raise ValueError(f"unknown vertex_layout {vertex_layout!r}; "
                         f"choose from {VERTEX_LAYOUTS}")
    if balancer is None:
        if spec is None:
            spec = BalanceSpec(p=p, method="hsfc", backend="sharded")
        balancer = Balancer(spec, device=el.grads.device, comm=comm)
    w = torch.ones(el.tets.shape[0], dtype=torch.float32,
                   device=el.grads.device)
    res = balancer.balance(w, coords=coords, old_parts=old_parts)
    parts = res.parts.cpu().numpy()
    halo = None
    if vertex_layout == "owned":
        halo = build_halo_plan(el.tets.cpu().numpy(), parts, el.n_verts, p)
    return shard_elements_on_device(el, parts, p, comm, halo=halo), res


def element_apply(t, g, v, u, nv: int, c: float = 0.0) -> torch.Tensor:
    """Element-local gather -> geometry apply -> scatter (the plain
    geometry form of the element pass).  Padded elements have g = 0,
    v = 0, so clamped gathers and dropped scatter ids add nothing."""
    t = t.long()
    ue = u[t.clamp(max=nv - 1)]
    flux = torch.einsum("cid,ci->cd", g, ue)
    au = torch.einsum("cjd,cd->cj", g, flux) * v[:, None]
    if c != 0.0:
        au = au + c * torch.einsum("ij,cj->ci", _mass(u.dtype, u.device),
                                   ue) * v[:, None]
    return segment_sum(au.reshape(-1), t.reshape(-1), nv)


def _element_pass(sel: ShardedElements, c: float,
                  use_pallas: Optional[bool]) -> Callable:
    """``apply(lo, hi, u, n_out)``: the element matvec over rows
    [lo, hi) of the packing, through an ``ElementOperator`` on element
    matrices built once here; one operator (with its kernel plan on the
    card) per (lo, hi, n_out), built at its first call and kept with the
    packing."""
    kel = fem_element_matrices(sel.grads, sel.vol, c).to(torch.float32)
    tets = sel.tets.contiguous()
    element_ops = {}

    def apply(lo: int, hi: Optional[int], u: torch.Tensor, n_out: int):
        key = (lo, hi, n_out)
        if key not in element_ops:
            element_ops[key] = ops.ElementOperator(
                tets[lo:hi], kel[lo:hi], n_out, use_pallas=use_pallas)
        return element_ops[key].apply(u)
    return apply


def make_sharded_matvec(sel: ShardedElements, comm, c: float = 0.0,
                        vertex_layout: Optional[str] = None, *,
                        overlap: Optional[bool] = None,
                        use_pallas: Optional[bool] = None
                        ) -> Tuple[Callable, tuple]:
    """Returns ``(matvec, (tets, grads, vol))`` for this rank.

    * ``"replicated"``: matvec maps (nv,) -> (nv,), both replicated; one
      ``psum``.
    * ``"owned"``: matvec maps this rank's (V,) -> (V,) in the packing's
      halo layout; the reduction is ``halo_reduce``.  The input must be
      ghost-consistent (every copy of a shared vertex equal), and so is
      the output.

    ``overlap`` (default: on whenever the packing carries a split point)
    computes the interface elements first, starts the first halo leg,
    computes the interior elements while it is in flight, then finishes
    the exchange.  Exact up to float summation order: interior elements
    touch no shared vertex.  ``overlap=False`` is the serial
    apply-everything-then-exchange form.  ``use_pallas`` selects the
    element-matvec kernel (None: on CUDA tensors)."""
    layout = _resolve_layout(sel, vertex_layout)
    apply = _element_pass(sel, c, use_pallas)
    arrays = (sel.tets, sel.grads, sel.vol)
    if layout == "replicated":
        nv = sel.n_verts

        def matvec(u):
            return comm.psum(apply(0, None, u, nv))
        return matvec, arrays

    plan = sel.halo
    rows = plan.rank_rows(comm.rank, sel.vol.device)
    send, recv = rows["send_idx"], rows["recv_idx"]
    order = rows["recv_order"]
    S = sel.n_interface
    if overlap is None:
        overlap = S is not None
    if overlap and S is None:
        raise ValueError("overlap needs an interface-split packing "
                         "(repack with shard_elements*/reshard_elements, "
                         "which set n_interface for owned layouts)")
    V = plan.V

    def matvec_owned(u):
        if not overlap:
            return halo_reduce(apply(0, None, u, V), send, recv, comm, order)
        y_if = apply(0, S, u, V)
        pending = halo_start(y_if, send, comm)
        y_int = apply(S, None, u, V)
        return halo_finish(y_if, pending, send, recv, comm, order) + y_int

    return matvec_owned, arrays


def _local_diag(sel: ShardedElements, c: float, n_out: int) -> torch.Tensor:
    d = torch.einsum("cid,cid->ci", sel.grads, sel.grads) * sel.vol[:, None]
    if c != 0.0:
        d = d + c * 0.1 * sel.vol[:, None]
    return segment_sum(d.reshape(-1), sel.tets.reshape(-1), n_out,
                       sel.order)


def sharded_diagonal(sel: ShardedElements, comm, c: float = 0.0,
                     vertex_layout: Optional[str] = None) -> torch.Tensor:
    """diag(A + cM) with the same reduction as the matvec: replicated
    returns (nv,), owned returns this rank's (V,)."""
    layout = _resolve_layout(sel, vertex_layout)
    if layout == "replicated":
        return comm.psum(_local_diag(sel, c, sel.n_verts))
    rows = sel.halo.rank_rows(comm.rank, sel.vol.device)
    return halo_reduce(_local_diag(sel, c, sel.halo.V), rows["send_idx"],
                       rows["recv_idx"], comm, rows["recv_order"])


def make_owned_operators(sel: ShardedElements, comm, c: float = 0.0, *,
                         overlap: Optional[bool] = None,
                         use_pallas: Optional[bool] = None
                         ) -> Tuple[Callable, torch.Tensor]:
    """(matvec, diagonal) pair for an owned-layout packing.  Build once
    per packing and reuse across solves: the element matrices are made
    here."""
    matvec, _ = make_sharded_matvec(sel, comm, c, vertex_layout="owned",
                                    overlap=overlap, use_pallas=use_pallas)
    return matvec, sharded_diagonal(sel, comm, c, vertex_layout="owned")


def measure_matvec_phases(sel: ShardedElements, comm, c: float = 0.0, *,
                          u: Optional[torch.Tensor] = None,
                          use_pallas: Optional[bool] = None,
                          **attrs) -> Tuple[float, float]:
    """Time the two phases of the split owned matvec separately.

    The overlapped matvec runs the interface pass + halo exchange
    concurrently with the interior pass, so their costs can only be
    separated out of band: each phase runs alone (warmed first) under the
    telemetry stopwatches ``fem/matvec_interface`` (the interface
    elements plus both exchange legs) and ``fem/matvec_interior``; returns
    ``(t_interface_s, t_interior_s)``.  The adaptive session records the
    pair as ``StepStats.t_matvec_halo`` / ``t_matvec_interior`` when
    tracing is on."""
    from .. import telemetry
    if sel.layout != "owned" or sel.halo is None or sel.n_interface is None:
        raise ValueError("measure_matvec_phases needs an interface-split "
                         "owned packing")
    plan, S = sel.halo, sel.n_interface
    rows = plan.rank_rows(comm.rank, sel.vol.device)
    apply = _element_pass(sel, c, use_pallas)
    if u is None:
        u = torch.ones(plan.V, dtype=sel.vol.dtype, device=sel.vol.device)

    def interface():
        return halo_reduce(apply(0, S, u, plan.V), rows["send_idx"],
                           rows["recv_idx"], comm, rows["recv_order"])

    def interior():
        return apply(S, None, u, plan.V)

    telemetry.block_until_ready([interface(), interior()])
    with telemetry.stopwatch("fem/matvec_interface", n_interface=S,
                             **attrs) as sw_if:
        sw_if.block_on(interface())
    with telemetry.stopwatch("fem/matvec_interior",
                             n_interior=int(sel.tets.shape[0]) - S,
                             **attrs) as sw_int:
        sw_int.block_on(interior())
    return sw_if.dur_s, sw_int.dur_s


def sharded_solve_dirichlet(sel: ShardedElements, comm, rhs: torch.Tensor,
                            g: torch.Tensor, free: torch.Tensor, c: float, *,
                            tol: float = 1e-8, maxiter: int = 2000,
                            operators: Optional[Tuple[Callable, torch.Tensor]]
                            = None,
                            overlap: Optional[bool] = None,
                            use_pallas: Optional[bool] = None) -> CGResult:
    """Owned-layout distributed PCG solve of (A + cM) u = rhs, u = g on
    pinned dofs.

    Takes the replicated (n_verts,) ``rhs`` / boundary values ``g`` /
    ``free`` mask (the same bits on every rank: a load vector summed with
    the card's atomics is broadcast first), converts them to this rank's
    (V,) halo layout, runs
    PCG whose every matvec communicates by ``halo_reduce`` and whose
    every inner product is an ownership-masked local sum plus one scalar
    psum, then assembles the solution back to (n_verts,) on every rank.
    ``operators``: a prebuilt ``make_owned_operators`` pair (then
    ``overlap`` / ``use_pallas`` are ignored)."""
    if sel.layout != "owned" or sel.halo is None:
        raise ValueError("sharded_solve_dirichlet needs an owned-layout "
                         "packing (pass halo= to the packer)")
    plan, rank = sel.halo, comm.rank
    rhs_l = plan.to_local(rhs, rank)
    g_l = plan.to_local(g, rank)
    free_l = plan.to_local(free, rank)
    owned = plan.rank_rows(rank, rhs.device)["owned_mask"]
    if operators is None:
        operators = make_owned_operators(sel, comm, c, overlap=overlap,
                                         use_pallas=use_pallas)
    matvec, diag_l = operators

    zero = torch.zeros((), dtype=rhs_l.dtype, device=rhs_l.device)
    g_ext = torch.where(free_l > 0, zero, g_l)
    lift = matvec(g_ext)
    b = torch.where(free_l > 0, rhs_l - lift, zero)
    diag = torch.where(free_l > 0, diag_l, torch.ones_like(diag_l))

    def op(u):
        au = matvec(u * free_l)
        return torch.where(free_l > 0, au, u)

    res = pcg(op, b, diag, torch.zeros_like(b), tol=tol, maxiter=maxiter,
              vdot=owned_vdot(owned, comm))
    x = plan.from_local(res.x + g_ext, comm)
    # pinned dofs globally: vertices no leaf element references are in no
    # part's local list, but the replicated solve still reports g there
    x = torch.where(free > 0, x, g)
    return CGResult(x, res.iters, res.residual)
