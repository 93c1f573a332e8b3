"""Owned-vertex halo exchange for the sharded FEM layer.

The paper's partition-quality metrics (surface index, aspect ratio) exist
to bound inter-process communication in the shared-vertex reduction.
This module is where that bound becomes operational: instead of
replicating the vertex vector and reducing it with one global ``psum``
per matvec (O(n_verts) wire traffic per rank regardless of partition
quality), each part *owns* a disjoint subset of the vertices and only the
vertices on cut edges -- the partition's halo -- travel, via a neighbour
``all_to_all``.  Halo traffic is proportional to the cut size, i.e. to
the surface index the balancer already reports.

Vocabulary (PHG thesis ch. 3 / deal.II ``parallel::distributed``):

owner        every vertex is owned by exactly one of the parts whose
             elements touch it (lowest part id -- deterministic and
             partition-independent);
local verts  per part: the vertices its elements reference, owned first
             then ghosts, both in ascending global id;
ghost/halo   a part's non-owned local vertices -- exactly the vertices
             shared with a neighbouring part across a cut edge/face;
plan         index maps (padded to the max counts ``V`` and ``H``)
             describing, for each ordered part pair, which local slots
             are shipped.

``halo_reduce`` is the communication primitive that replaces the psum:

1. accumulate: every toucher sends its ghost partial sums to the owner
   (one ``all_to_all``), the owner scatter-adds them into its owned
   slots -- after this the owner holds the fully assembled value;
2. restore: the owner sends the assembled values back to every toucher
   (second ``all_to_all``), which overwrites its ghost slots -- after
   this *all* copies of a shared vertex agree, the invariant the next
   element-local gather needs.

Both legs ship ``(p, H)`` buffers where only real ghost slots are
non-padding, so the wire volume scales with the partition's cut, not
with the mesh size.  Counterpart of ``repro.fem.halo``: the plan builders
are the same host numpy code with the same slot order (the plan is
built on every rank from the replicated mesh), and ``halo_reduce`` runs
on each rank over a ``distributed.Comm``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..segment import segment_sum


@dataclass(frozen=True)
class HaloPlan:
    """The owned-vertex sharding maps (host numpy arrays, the same on
    every rank; ``rank_rows`` gives one rank's rows as tensors).

    Arrays:

    local_verts      (p, V) int32   global id per local slot, pad ``n_verts``
    owned_mask       (p, V) bool    True on slots the part owns
    global_to_local  (p, n_verts) int32  local slot of a global vertex,
                                    ``V`` where the vertex is not local
    send_idx         (p, p, H) int32  ``send_idx[s, d]``: s-local slots of
                                    s's ghosts owned by d, pad ``V``
    recv_idx         (p, p, H) int32  ``recv_idx[d, s]``: d-local slots the
                                    same vertices occupy on the owner d
                                    (mirrors ``send_idx[s, d]`` slot for
                                    slot), pad ``V``
    owner            (n_verts,) int32  owning part, ``p`` for vertices no
                                    leaf element references

    Sizes: ``p``, ``n_verts``, ``V``, ``H``, per-part counts
    ``n_local`` / ``n_owned``, ``n_ghost_total``.
    """
    local_verts: np.ndarray
    owned_mask: np.ndarray
    global_to_local: np.ndarray
    send_idx: np.ndarray
    recv_idx: np.ndarray
    owner: np.ndarray
    p: int
    n_verts: int
    V: int
    H: int
    n_local: Tuple[int, ...]
    n_owned: Tuple[int, ...]
    n_ghost_total: int

    # -- communication model -----------------------------------------------
    def halo_bytes(self, itemsize: int = 4) -> int:
        """Wire bytes of one ``halo_reduce`` (both legs, real slots only:
        padding slots carry zeros and a production pack would trim them).
        Proportional to the partition's cut -- the surface index made
        operational."""
        return 2 * self.n_ghost_total * itemsize

    def psum_bytes(self, itemsize: int = 4) -> int:
        """Wire bytes of the replicated-path reduction this plan replaces:
        every part contributes its full (n_verts,) partial vector to the
        all-reduce."""
        return self.p * self.n_verts * itemsize

    # -- element classification (host/control plane) -----------------------
    def shared_vertex_mask(self) -> np.ndarray:
        """(n_verts,) bool: vertices local to >= 2 parts.

        Exactly the vertices ``halo_reduce`` reads or writes (every ghost
        copy and its owner slot).  An element none of whose vertices are
        shared is *interior*: it contributes nothing to any slot the
        exchange touches, so its work can overlap the ``all_to_all``
        legs -- the classification the interface-first element packing
        in ``fem.parallel`` is built on.  Host-side numpy (runs once per
        repartition, alongside plan construction)."""
        g2l = np.asarray(self.global_to_local)
        return (g2l < self.V).sum(axis=0) >= 2

    # -- one rank's rows and layout conversions ------------------------------
    def rank_rows(self, rank: int, device) -> Dict[str, torch.Tensor]:
        """Rank ``rank``'s rows as tensors on ``device``: ``local_verts``
        and ``owned_mask`` (V,), ``send_idx`` and ``recv_idx`` (p, H)."""
        return {name: torch.as_tensor(np.asarray(getattr(self, name)[rank]),
                                      device=device)
                for name in ("local_verts", "owned_mask", "send_idx",
                             "recv_idx")}

    def to_local(self, u: torch.Tensor, rank: int) -> torch.Tensor:
        """Replicated (n_verts,) -> rank's (V,) local layout (padding 0)."""
        lv = torch.as_tensor(self.local_verts[rank], device=u.device).long()
        safe = torch.clamp(lv, max=self.n_verts - 1)
        return torch.where(lv < self.n_verts, u[safe], torch.zeros_like(u[safe]))

    def from_local(self, ul: torch.Tensor, comm) -> torch.Tensor:
        """Every rank's (V,) local layout -> replicated (n_verts,).

        Every global vertex has exactly one owner slot, so each rank
        scatters its owned slots and one psum assembles the vector
        exactly (vertices no part touches come back 0)."""
        rank = comm.rank
        owned = torch.as_tensor(self.owned_mask[rank], device=ul.device)
        lv = torch.as_tensor(self.local_verts[rank], device=ul.device).long()
        out = ul.new_zeros(self.n_verts)
        out[lv[owned]] = ul[owned]
        return comm.psum(out)


def publish_wire_model(plan: HaloPlan, metrics, *, itemsize: int = 4) -> None:
    """Publish the plan's per-matvec wire model to a telemetry registry.

    One gauge per layout: what a single reduction puts on the wire under
    the halo exchange (cut-proportional) vs the replicated psum it
    replaces (mesh-proportional).  ``metrics`` is a
    ``telemetry.MetricsRegistry`` (or the null registry)."""
    metrics.gauge(
        "comm_halo_bytes", unit="bytes",
        help="one halo_reduce, both all_to_all legs "
             "(cut-proportional)").set(int(plan.halo_bytes(itemsize)))
    metrics.gauge(
        "comm_psum_bytes", unit="bytes",
        help="the replicated-path psum this plan replaces "
             "(mesh-proportional)").set(int(plan.psum_bytes(itemsize)))


def build_halo_plan(tets, parts, n_verts: int, p: int) -> HaloPlan:
    """Derive the owned-vertex sharding from a partition + connectivity.

    ``tets``: (nt, 4) global vertex ids; ``parts``: (nt,) part id per
    element in [0, p).  Pure host/numpy -- runs once per repartition.
    """
    tets = np.asarray(tets, np.int64)
    parts = np.asarray(parts, np.int64)
    if tets.shape[0] != parts.shape[0]:
        raise ValueError(f"tets/parts length mismatch: {tets.shape[0]} vs "
                         f"{parts.shape[0]}")
    # unique (vertex, toucher part) incidence, sorted by (vertex, part)
    keys = np.unique(tets.reshape(-1) * p + np.repeat(parts, 4))
    inc_v = keys // p
    inc_p = (keys % p).astype(np.int32)
    # owner = lowest-id toucher; p = sentinel for untouched vertices
    owner = np.full(n_verts, p, np.int32)
    np.minimum.at(owner, inc_v, inc_p)

    # per-part local lists: owned first, then ghosts, each in global order
    locals_ = []
    for s in range(p):
        mine = inc_v[inc_p == s]                       # sorted global ids
        own = mine[owner[mine] == s]
        ghost = mine[owner[mine] != s]
        locals_.append((own, ghost))
    return _assemble_plan(locals_, owner, n_verts, p)


def _assemble_plan(locals_, owner, n_verts: int, p: int) -> HaloPlan:
    """Pad + index the per-part (own, ghost) lists into a ``HaloPlan``.

    Shared by the from-scratch and the incremental builders so both emit
    byte-identical plans from identical lists."""
    owned_counts = [int(o.size) for o, _ in locals_]
    V = max(1, max(o.size + g.size for o, g in locals_))

    local_verts = np.full((p, V), n_verts, np.int32)
    owned_mask = np.zeros((p, V), bool)
    g2l = np.full((p, n_verts), V, np.int32)
    n_local = []
    for s, (own, ghost) in enumerate(locals_):
        lv = np.concatenate([own, ghost])
        local_verts[s, :lv.size] = lv
        owned_mask[s, :own.size] = True
        g2l[s, lv] = np.arange(lv.size, dtype=np.int32)
        n_local.append(int(lv.size))

    # per ordered pair (toucher s, owner d): the shared vertex set in
    # ascending global id -- both sides enumerate it identically, so the
    # H-slot ordering matches without any extra handshake
    pair_sets = [[None] * p for _ in range(p)]
    H = 1
    for s, (_, ghost) in enumerate(locals_):
        if ghost.size:
            gowner = owner[ghost]
            for d in np.unique(gowner):
                shared = ghost[gowner == d]            # already sorted
                pair_sets[s][d] = shared
                H = max(H, shared.size)
    send_idx = np.full((p, p, H), V, np.int32)
    recv_idx = np.full((p, p, H), V, np.int32)
    n_ghost_total = 0
    for s in range(p):
        for d in range(p):
            shared = pair_sets[s][d]
            if shared is None:
                continue
            send_idx[s, d, :shared.size] = g2l[s, shared]
            recv_idx[d, s, :shared.size] = g2l[d, shared]
            n_ghost_total += int(shared.size)

    return HaloPlan(
        local_verts, owned_mask, g2l, send_idx, recv_idx,
        np.asarray(owner, np.int32),
        p, int(n_verts), int(V), int(H), tuple(n_local),
        tuple(owned_counts), n_ghost_total)


def _assemble_delta(plan: HaloPlan, locals_, owner, a_ids, n_verts: int,
                    p: int):
    """Copy-path assembly: reuse ``plan``'s padded arrays, rewriting only
    the rows of affected parts and the pair slots that reference them.
    Pad extents (``V``, ``H``, ``n_verts``) that moved are absorbed by
    bulk copy + sentinel remap.  Returns ``None`` when the copy path
    cannot apply (sentinel overflow) so the caller falls back to
    ``_assemble_plan`` on the same lists -- identical output either way,
    this is purely a fast path."""
    if n_verts >= 2 ** 31:
        return None
    n_local = [int(o.size + g.size) for o, g in locals_]
    V = max(1, max(n_local))
    # pair sets for every part -- O(sum ghosts), needed to size H and to
    # refresh recv slots whose owner row re-indexed
    pair_sets = [[None] * p for _ in range(p)]
    H = 1
    for s, (_, ghost) in enumerate(locals_):
        if ghost.size:
            gowner = owner[ghost]
            for d in np.unique(gowner):
                shared = ghost[gowner == d]
                pair_sets[s][d] = shared
                H = max(H, shared.size)

    # bulk-copy the old padded arrays, resizing pads when V/H/n_verts
    # moved.  Safe because real entries are strictly below every old pad
    # sentinel (slot ids < n_local <= V, vertex ids < n_verts), so the
    # sentinels can be remapped by equality, and any truncated tail holds
    # only pads (the new extents still bound every copied row's reals).
    oV, oH, onv = plan.V, plan.H, plan.n_verts
    a_mask = np.zeros(p, bool)
    a_mask[a_ids] = True
    lv_old = np.asarray(plan.local_verts)
    if V == oV and n_verts == onv:
        local_verts = lv_old.copy()
    else:
        local_verts = np.full((p, V), n_verts, np.int32)
        m = min(V, oV)
        local_verts[:, :m] = lv_old[:, :m]
        if n_verts != onv:
            local_verts[local_verts == onv] = n_verts
    om_old = np.asarray(plan.owned_mask)
    if V == oV:
        owned_mask = om_old.copy()
    else:
        owned_mask = np.zeros((p, V), bool)
        m = min(V, oV)
        owned_mask[:, :m] = om_old[:, :m]
    g_old = np.asarray(plan.global_to_local)
    if V == oV and n_verts == onv:
        g2l = g_old.copy()
        for s in a_ids:
            own, ghost = locals_[s]
            lv = np.concatenate([own, ghost])
            g2l[s] = V
            g2l[s, lv] = np.arange(lv.size, dtype=np.int32)
    else:
        # pad sentinel V moved: refilling every row from its list beats
        # an equality remap over the whole (p, n_verts) map
        g2l = np.full((p, n_verts), V, np.int32)
        for s, (own, ghost) in enumerate(locals_):
            lv = np.concatenate([own, ghost])
            g2l[s, lv] = np.arange(lv.size, dtype=np.int32)
    for s in a_ids:
        own, ghost = locals_[s]
        lv = np.concatenate([own, ghost])
        local_verts[s] = n_verts
        local_verts[s, :lv.size] = lv
        owned_mask[s] = False
        owned_mask[s, :own.size] = True
    s_old = np.asarray(plan.send_idx)
    r_old = np.asarray(plan.recv_idx)
    resized = not (V == oV and H == oH)
    if resized:
        # real pair slices are sparse (each part only has a few
        # neighbors): re-pad once, copy only real slots -- no old pads
        # ever enter, so no remap pass
        send_idx = np.full((p, p, H), V, np.int32)
        recv_idx = np.full((p, p, H), V, np.int32)
    else:
        send_idx = s_old.copy()
        recv_idx = r_old.copy()
        for s in a_ids:
            send_idx[s] = V
            recv_idx[:, s] = V
    n_owned = [int(o.size) for o, _ in locals_]
    n_ghost_total = 0
    for s in range(p):
        row = pair_sets[s]
        for d in range(p):
            shared = row[d]
            if shared is None:
                continue
            k = int(shared.size)
            n_ghost_total += k
            if a_mask[s]:
                send_idx[s, d, :k] = g2l[s, shared]
                recv_idx[d, s, :k] = g2l[d, shared]
            elif a_mask[d]:
                # s's ghost set owned by d is unchanged, but d's local
                # numbering moved: refresh the owner-side slots
                if resized:
                    send_idx[s, d, :k] = s_old[s, d, :k]
                recv_idx[d, s, :k] = g2l[d, shared]
            elif resized:
                send_idx[s, d, :k] = s_old[s, d, :k]
                recv_idx[d, s, :k] = r_old[d, s, :k]

    return HaloPlan(
        local_verts, owned_mask, g2l, send_idx, recv_idx,
        np.asarray(owner, np.int32),
        p, int(n_verts), int(V), int(H), tuple(n_local), tuple(n_owned),
        n_ghost_total)


def update_halo_plan(plan: HaloPlan, old_tets, old_parts, tets, parts,
                     n_verts: int, p: int) -> Tuple[HaloPlan, Dict]:
    """Rebuild a ``HaloPlan`` from the refinement/migration *delta*.

    ``plan`` must describe ``(old_tets, old_parts)``; the returned plan is
    field-by-field identical to ``build_halo_plan(tets, parts, n_verts, p)``
    (the from-scratch build stays the parity oracle), but the expensive
    incidence pass and per-part list construction run only over the
    *affected* parts ``A``:

    * parts of new elements with no same-part old twin (dirty),
    * old parts of old elements with no same-part new twin (vanished),
    * parts whose old local set touches any vertex of a dirty/vanished
      element (their owned/ghost split can flip when an owner changes).

    Every new toucher of a dirty vertex lies in ``A`` (a matched element
    keeps its part, so its old toucher pairs put that part in ``A``), so
    owners of dirty vertices are recoverable from ``A``'s incidence alone;
    owners of clean vertices are unchanged.  Parts outside ``A`` copy
    their (own, ghost) lists verbatim from ``plan``; pad re-indexing and
    all pair sets are recomputed globally (cheap, O(sum ghosts)).

    Falls back to a full ``build_halo_plan`` when the plan does not match
    (different ``p``, shrinking vertex range) or when ``A`` is all parts.
    Returns ``(plan, info)`` with ``info['mode']`` in ``{"noop", "delta",
    "full"}`` plus delta statistics.
    """
    old_tets = np.asarray(old_tets, np.int64)
    old_parts = np.asarray(old_parts, np.int64)
    tets = np.asarray(tets, np.int64)
    parts = np.asarray(parts, np.int64)
    if tets.shape[0] != parts.shape[0]:
        raise ValueError(f"tets/parts length mismatch: {tets.shape[0]} vs "
                         f"{parts.shape[0]}")

    def full(reason: str) -> Tuple[HaloPlan, Dict]:
        return build_halo_plan(tets, parts, n_verts, p), {
            "mode": "full", "reason": reason}

    if plan is None or plan.p != p or plan.n_verts > n_verts:
        return full("plan mismatch")
    if old_tets.shape[0] != old_parts.shape[0]:
        return full("old tets/parts mismatch")

    # -- match elements: an element is clean iff the same (row, part)
    #    pair exists on both sides (row identity, not row position).
    #    Positional comparison is a sound conservative shortcut (a
    #    positionally-clean element is set-clean; a false dirty only
    #    enlarges A, never corrupts the plan), and migration-only steps
    #    keep every row in place -- so try it first and only fall back
    #    to the full sort-based match when it looks too pessimistic.
    no = old_tets.shape[0]
    matched = None
    if old_tets.shape == tets.shape:
        rows_eq = (old_tets == tets).all(axis=1)
        pos_clean = rows_eq & (old_parts == parts)
        # identical connectivity (migration-only step): positional IS the
        # set match; with moved rows only take it while it stays tight
        if rows_eq.all() or pos_clean.mean() >= 0.75:
            matched = np.concatenate([pos_clean, pos_clean])
    if matched is None:
        all_rows = np.concatenate([old_tets, tets], axis=0)
        if n_verts < 2 ** 31:
            # pack each row into two int64 keys and lexsort once over
            # (row, part): a group matched on both sides is clean.  Much
            # cheaper than np.unique(axis=0)'s void-view argsort + isin.
            hi = all_rows[:, 0] * n_verts + all_rows[:, 1]
            lo = all_rows[:, 2] * n_verts + all_rows[:, 3]
            prt = np.concatenate([old_parts, parts])
            order = np.lexsort((prt, lo, hi))
            h_s, l_s, q_s = hi[order], lo[order], prt[order]
            brk = np.empty(order.size, bool)
            brk[0] = True
            brk[1:] = ((h_s[1:] != h_s[:-1]) | (l_s[1:] != l_s[:-1])
                       | (q_s[1:] != q_s[:-1]))
            gid = np.cumsum(brk) - 1
            side_old = order < no
            has_old = np.zeros(int(gid[-1]) + 1 if gid.size else 0, bool)
            has_new = np.zeros(has_old.size, bool)
            has_old[gid[side_old]] = True
            has_new[gid[~side_old]] = True
            matched = np.empty(order.size, bool)
            matched[order] = has_old[gid] & has_new[gid]
        else:
            _, inv = np.unique(all_rows, axis=0, return_inverse=True)
            inv = inv.reshape(-1)          # numpy>=2 keeps the 2-D shape
            old_ids = inv[:no] * (p + 1) + old_parts
            new_ids = inv[no:] * (p + 1) + parts
            matched = np.concatenate([np.isin(old_ids, new_ids),
                                      np.isin(new_ids, old_ids)])
    dirty_new = ~matched[no:]
    vanished = ~matched[:no]
    n_dirty = int(dirty_new.sum())
    n_vanished = int(vanished.sum())
    if n_dirty == 0 and n_vanished == 0 and n_verts == plan.n_verts:
        return plan, {"mode": "noop", "n_dirty_new": 0, "n_vanished_old": 0,
                      "n_affected_parts": 0}

    dirty_verts = np.unique(np.concatenate(
        [tets[dirty_new].reshape(-1), old_tets[vanished].reshape(-1)]))

    # -- affected parts: anyone assigned a dirty/vanished element, plus
    #    anyone whose old local set touches a dirty vertex
    a_mask = np.zeros(p, bool)
    a_mask[parts[dirty_new]] = True
    a_mask[old_parts[vanished]] = True
    g2l_old = np.asarray(plan.global_to_local)
    dv_old = dirty_verts[dirty_verts < plan.n_verts]
    if dv_old.size:
        a_mask |= (g2l_old[:, dv_old] < plan.V).any(axis=1)
    a_ids = np.flatnonzero(a_mask)
    if a_ids.size == p:
        new_plan, info = full("all parts affected")
        info.update(n_dirty_new=n_dirty, n_vanished_old=n_vanished,
                    n_affected_parts=p)
        return new_plan, info

    # -- owner: clean vertices keep theirs; dirty vertices are re-derived
    #    from A's incidence (which contains all of their new touchers)
    owner = np.full(n_verts, p, np.int32)
    owner[:plan.n_verts] = np.asarray(plan.owner)
    owner[dirty_verts] = p
    sel = a_mask[parts]
    keys = np.unique(tets[sel].reshape(-1) * p + np.repeat(parts[sel], 4))
    inc_v = keys // p
    inc_p = (keys % p).astype(np.int32)
    np.minimum.at(owner, inc_v, inc_p)

    # -- per-part lists: rebuild inside A, copy verbatim outside
    lv_old = np.asarray(plan.local_verts)
    locals_: List[Tuple[np.ndarray, np.ndarray]] = []
    for s in range(p):
        if a_mask[s]:
            mine = inc_v[inc_p == s]                   # sorted global ids
            own = mine[owner[mine] == s]
            ghost = mine[owner[mine] != s]
        else:
            lv = lv_old[s, :plan.n_local[s]].astype(np.int64)
            own, ghost = lv[:plan.n_owned[s]], lv[plan.n_owned[s]:]
        locals_.append((own, ghost))

    new_plan = _assemble_delta(plan, locals_, owner, a_ids, n_verts, p)
    assembly = "copy"
    if new_plan is None:                   # padded shapes changed
        new_plan = _assemble_plan(locals_, owner, n_verts, p)
        assembly = "full"
    return new_plan, {"mode": "delta", "assembly": assembly,
                      "n_dirty_new": n_dirty,
                      "n_vanished_old": n_vanished,
                      "n_affected_parts": int(a_ids.size)}


def halo_reduce(y: torch.Tensor, send_idx: torch.Tensor,
                recv_idx: torch.Tensor, comm) -> torch.Tensor:
    """Assemble shared-vertex sums with two neighbour ``all_to_all`` legs.

    ``y``: (V,) this part's local partial sums (every local slot holds
    only the contributions of the part's own elements); ``send_idx`` /
    ``recv_idx``: this part's (p, H) rows of the plan.  Returns (V,) with
    every slot -- owned and ghost -- holding the fully assembled value.
    Padding slots (index V) contribute zeros on the wire and are masked
    out of the scatters (the JAX package drops them)."""
    return halo_finish(y, halo_start(y, send_idx, comm), send_idx, recv_idx,
                       comm)


def halo_start(y: torch.Tensor, send_idx: torch.Tensor, comm):
    """Leg 1 of ``halo_reduce``, started: ghost partials -> owner.  The
    returned exchange is finished by ``halo_finish``; work that touches
    no shared vertex can run in between."""
    V = y.shape[0]
    s = send_idx.long()
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    out = torch.where(s < V, y[s.clamp(max=V - 1)], zero)
    return comm.all_to_all_async(out.reshape(-1))


def halo_finish(y: torch.Tensor, pending, send_idx: torch.Tensor,
                recv_idx: torch.Tensor, comm) -> torch.Tensor:
    """Wait for leg 1, add it into the owned slots, then leg 2 (restore):
    the assembled owner values go back to every toucher's ghost slots.
    Leg 1's contributions are summed per slot by ``segment_sum``, in an
    order fixed by the plan on the card (padding slots, index V,
    dropped), then added to ``y``."""
    V = y.shape[0]
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    r = recv_idx.reshape(-1).long()
    s = send_idx.reshape(-1).long()
    contrib = pending.wait()                      # (p*H,), blocks = source
    y = y + segment_sum(contrib, r, V)
    back = torch.where(r < V, y[r.clamp(max=V - 1)], zero)
    ghosts = comm.all_to_all(back)                # blocks = owner
    keep = s < V
    y[s[keep]] = ghosts[keep]
    return y
