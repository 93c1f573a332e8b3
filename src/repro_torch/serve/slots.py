"""KV-cache slots: layout, slot writes, the paged insert of the packed
prefill, and the migration of slots between the ranks of a group.
Counterpart of ``repro/serve/slots.py``.

The serving state is a ``decode.KVCache`` whose batch dimension is a slot
axis.  On one device it holds every global slot (``spec.total_slots``
rows).  Over a process group of ``spec.groups`` ranks (one process per
request group, ``distributed.comm.Comm``), rank r holds only its group's
global slots ``[r*spg, (r+1)*spg)`` as rows ``[0, spg)``: the reference's
``(g, slots/g, ...)`` layout over its group mesh, with the shards in rank
order forming the reference's global state.

* ``slot_axes`` names the slot axis of each field; ``n_slots_of`` reads
  its length; ``slot_nbytes`` is the bytes of one slot row.
* ``write_slot`` merges a batch-1 prefill cache into one row;
  ``make_paged_insert`` scatters a packed prefill's K/V into many slots
  page by page, each rank keeping the pages of its own slots.
* ``check_serve_world`` checks that a ``Comm`` has one rank per group;
  ``make_sharded_decode`` is the per-group decode; ``SlotMigrator`` ships
  slot rows between ranks with ``distributed.migrate.migrate_items``, the
  fixed-capacity all_to_all executor of the FEM element migration.

All of them write the state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..distributed.migrate import migrate_items
from ..models.config import ModelConfig
from .decode import KVCache, _kv_family, decode_step

# the slot axis of each field: k / v are (L, b, hkv, S, hd)
_KV_AXES = KVCache(k=1, v=1, stored_pos=0, pos=0)
# a send buffer of one migration chunk stays under this many bytes (the
# k and v rows of as many layers as fit; at least one layer a chunk)
MIGRATE_CHUNK_BYTES = 1 << 28


def slot_axes(cfg: ModelConfig) -> KVCache:
    """Slot-axis index of each field of the serving state."""
    _kv_family(cfg)
    return _KV_AXES


def _fields(x):
    return [getattr(x, f.name) for f in dataclasses.fields(x)]


def slot_nbytes(state: KVCache, axes: KVCache) -> int:
    """Bytes of one slot row across the state: the unit of the migration
    volume accounting."""
    return sum(leaf.numel() // leaf.shape[ax] * leaf.element_size()
               for leaf, ax in zip(_fields(state), _fields(axes)))


def n_slots_of(state: KVCache, axes: KVCache) -> int:
    """Slot-axis length of a state: the global slot count on one device,
    a rank's ``spg`` rows over a group."""
    return int(state.k.shape[axes.k])


def write_slot(state: KVCache, row: KVCache, slot: int, axes: KVCache
               ) -> KVCache:
    """Overwrite row ``slot`` of ``state`` with the batch-1 state ``row``
    (a prefill cache of the same ``max_seq``), in place."""
    for leaf, r, ax in zip(_fields(state), _fields(row), _fields(axes)):
        idx = (slice(None),) * ax
        leaf[idx + (slot,)] = r[idx + (0,)]
    return state


def check_serve_world(groups: int, comm) -> None:
    """The counterpart of the reference's ``build_serve_mesh``: sharded
    serving runs one rank per request group.  (The reference's
    ``slot_pspecs`` shards every field's slot axis over the mesh; a
    ``PartitionSpec`` has no torch counterpart, since each rank simply
    allocates its own ``spg`` rows.)"""
    if comm is None:
        raise ValueError("sharded serving needs a process group: pass "
                         "comm=distributed.Comm(...) (one rank per group)")
    if comm.size != groups:
        raise ValueError(f"need {groups} ranks for sharded serving, have "
                         f"{comm.size} (one rank per group)")


def make_sharded_decode(cfg: ModelConfig, comm):
    """The decode of a group: each rank advances its own ``spg`` rows with
    the replicated weights (``decode_step``), and one ``all_gather`` of
    the ``(spg,)`` argmax tokens gives every rank the tokens of all
    groups in global slot order (the reference's ``out_specs=P(AXIS)``).
    Returns ``decode(model, state, tokens) -> (logits, next_tokens)``
    with the logits of this rank's rows and ``next_tokens`` of every
    slot."""
    _kv_family(cfg)

    def decode(model, state: KVCache, tokens: torch.Tensor):
        logits, _ = decode_step(model, state, tokens, cfg)
        return logits, comm.all_gather(torch.argmax(logits[:, -1], dim=-1))

    return decode


def make_paged_insert(cfg: ModelConfig, comm=None, *, total_slots: int,
                      page_size: int, capacity: int):
    """The page-granular scatter of packed-prefill K/V into many slots.

    The packed prefill emits K/V for the whole buffer, (L, hkv, C, hd)
    with C = capacity = n_pages * page_size.  Buffer page p lands in slot
    ``page_slot[p]`` at page index ``page_dst[p]``; ``page_slot = -1``
    marks a pad page, which lands nowhere.  ``written`` (total_slots,)
    bool marks the admitted slots and ``slen`` their prompt lengths:
    written slots get ``stored_pos = [0 .. slen) then -1`` and ``pos =
    slen``.  Stale K/V past ``slen`` is harmless, since decode masks on
    ``stored_pos``.

    With ``comm`` (one rank per group) the state holds rank r's slots
    ``[r*spg, (r+1)*spg)``: the rank keeps only the pages of those slots
    and its rows of ``written`` and ``slen`` (the reference's ``base =
    axis_index * spg``).  The reference scatters with ``mode='drop'``,
    which silently drops out-of-range indices; torch indexing raises
    instead, so the other pages are masked explicitly.  Returns
    ``insert(state, pk, pv, page_slot, page_dst, written, slen)``, which
    updates ``state`` in place."""
    _kv_family(cfg)
    n_pages = capacity // page_size
    base = 0
    if comm is not None:
        if total_slots % comm.size:
            raise ValueError(f"{total_slots} slots do not split into "
                             f"{comm.size} groups")
        base = comm.rank * (total_slots // comm.size)

    def insert(state: KVCache, pk, pv, page_slot, page_dst, written, slen
               ) -> KVCache:
        L, sl, hkv, S, hd = state.k.shape
        sp_pages = S // page_size
        local = page_slot.long() - base
        keep = ((page_slot >= 0) & (local >= 0) & (local < sl)
                & (page_dst >= 0) & (page_dst < sp_pages))
        ls, pd = local[keep], page_dst[keep].long()
        k6 = state.k.view(L, sl, hkv, sp_pages, page_size, hd)
        v6 = state.v.view(L, sl, hkv, sp_pages, page_size, hd)
        # advanced indices (ls, pd) separated by a slice: the indexed view
        # is (P, L, hkv, page_size, hd), the advanced dim first
        k6[:, ls, :, pd] = pk.view(L, hkv, n_pages, page_size, hd
                                   ).movedim(2, 0)[keep]
        v6[:, ls, :, pd] = pv.view(L, hkv, n_pages, page_size, hd
                                   ).movedim(2, 0)[keep]
        wl, sll = written[base:base + sl], slen[base:base + sl]
        iota = torch.arange(S, dtype=torch.int32, device=state.k.device)[None]
        fresh = torch.where(iota < sll[:, None], iota, -1)
        state.stored_pos.copy_(torch.where(wl[:, None], fresh,
                                           state.stored_pos))
        state.pos.copy_(torch.where(wl, sll, state.pos))
        return state

    return insert


class SlotMigrator:
    """Ship KV slot rows between the ranks of a group with the all_to_all
    executor.

    ``__call__(state, moves)`` with ``moves`` a sequence of ``(src_slot,
    dst_slot)`` global slot ids executes every move in one exchange (a
    destination slot may itself be vacated in the same round: each chunk's
    payload is read before its arrivals are written).  Every rank calls
    it with the same moves; ``state`` is the rank's own ``spg`` rows,
    updated in place.  Returns the state and the executor's volume
    scalars, summed over the ranks.

    The payload is each field's slot rows, slot axis first, weighted by
    ``slot_nbytes``.  It is shipped in chunks of layers whose send buffer
    stays under ``chunk_bytes`` (at least one layer a chunk), with the
    same plan for every chunk, so the bits received equal one whole
    call's; the volume scalars come from the first chunk.  The fixed
    capacity ships ``groups * spg`` rows a call, moved or not: the bytes
    put on the exchange are counted in ``comm.all_to_all_bytes``."""

    def __init__(self, cfg: ModelConfig, comm, axes: KVCache,
                 state_template: KVCache, *,
                 chunk_bytes: int = MIGRATE_CHUNK_BYTES):
        _kv_family(cfg)
        self.comm, self.axes = comm, axes
        self.groups = comm.size
        self.spg = n_slots_of(state_template, axes)
        self.slots = self.groups * self.spg
        self.bytes_per_slot = slot_nbytes(state_template, axes)
        self.chunk_bytes = chunk_bytes

    def plan(self, moves: Sequence[Tuple[int, int]]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side move plan over the global slots: ``(dest, valid,
        recv_slot)``, the same on every rank.

        ``recv_slot`` encodes, per destination group, the local slot of
        the j-th arrival (arrival order = ascending source slot id, the
        executor's source-major compaction order); unused receive rows
        point at ``spg``, which the scatter drops."""
        g, spg = self.groups, self.spg
        dest = np.arange(self.slots, dtype=np.int64) // spg
        valid = np.zeros(self.slots, bool)
        recv = np.full(self.slots, spg, np.int64)
        counts = [0] * g
        for src, dst in sorted(moves):          # ascending src slot id
            if not 0 <= src < self.slots or not 0 <= dst < self.slots:
                raise ValueError(f"move {(src, dst)} outside slot range")
            if valid[src]:
                raise ValueError(f"slot {src} moved twice in one round")
            dg = dst // spg
            if counts[dg] == spg:
                raise ValueError("more arrivals than slots in one group")
            dest[src] = dg
            valid[src] = True
            recv[dg * spg + counts[dg]] = dst % spg
            counts[dg] += 1
        return dest, valid, recv

    def _chunks(self, state: KVCache) -> List[Dict[str, torch.Tensor]]:
        """Payload views, slot axis first: k and v a range of layers at a
        time, the positions with the first range."""
        L = state.k.shape[0]
        row_layer = 2 * state.k[0, 0].numel() * state.k.element_size()
        per = max(1, self.chunk_bytes // (self.groups * self.spg * row_layer))
        out = []
        for l0 in range(0, L, per):
            chunk = {"k": state.k[l0:l0 + per].movedim(1, 0),
                     "v": state.v[l0:l0 + per].movedim(1, 0)}
            if l0 == 0:
                chunk.update(stored_pos=state.stored_pos, pos=state.pos)
            out.append(chunk)
        return out

    def __call__(self, state: KVCache, moves: Sequence[Tuple[int, int]]
                 ) -> Tuple[KVCache, Dict[str, float]]:
        if not moves:
            return state, {"moved_bytes": 0.0, "received_bytes": 0.0,
                           "n_moved": 0, "overflow": 0}
        dest, valid, recv = self.plan(moves)
        g, spg, dev = self.groups, self.spg, state.k.device
        mine = slice(self.comm.rank * spg, (self.comm.rank + 1) * spg)
        dest_l = torch.as_tensor(dest[mine], device=dev)
        valid_l = torch.as_tensor(valid[mine], device=dev)
        recv_l = recv[mine]
        rows = np.flatnonzero(recv_l < spg)
        rows_t = torch.as_tensor(rows, device=dev)
        into = torch.as_tensor(recv_l[rows], device=dev)
        w = torch.full((spg,), float(self.bytes_per_slot),
                       dtype=torch.float32, device=dev)
        first = None
        for payload in self._chunks(state):
            mig = migrate_items(payload, dest_l, w, self.comm, g,
                                valid=valid_l, capacity=spg)
            if first is None:
                first = mig
            for k, leaf in payload.items():
                leaf[into] = mig.payload[k][rows_t]
        stats = self.comm.psum(torch.stack([
            first.w_sent.double(), first.w_received.double(),
            first.n_recv.double(), first.overflow.double()]))
        moved, received, n, over = stats.tolist()
        return state, {"moved_bytes": moved, "received_bytes": received,
                       "n_moved": int(n), "overflow": int(over)}
