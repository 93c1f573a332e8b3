"""Serving-state slots: layout, slot writes, the paged insert of the
packed prefill, and the migration of slots between the ranks of a group.
Counterpart of ``repro/serve/slots.py``.

The serving state is the family's state of ``serve.decode`` (a
``KVCache``, an ``SSMState``, a ``HybridState`` or an ``EncDecState``)
whose batch dimension
is a slot axis.  On one device it holds every global slot
(``spec.total_slots`` rows).  Over a process group of ``spec.groups``
ranks (one process per request group, ``distributed.comm.Comm``), rank r
holds only its group's global slots ``[r*spg, (r+1)*spg)`` as rows
``[0, spg)``: the reference's ``(g, slots/g, ...)`` layout over its group
mesh, with the shards in rank order forming the reference's global
state.

* ``slot_axes`` gives a tree of the state's own structure (dataclasses
  and tuples) whose leaves name the slot axis of each tensor; every other
  helper walks the state and that tree together, so all families share
  the code.  ``n_slots_of`` reads the slot-axis length; ``slot_nbytes`` is
  the bytes of one slot row.
* ``write_slot`` merges a batch-1 prefill state into one row;
  ``make_paged_insert`` scatters a packed prefill's K/V into many slots
  page by page, each rank keeping the pages of its own slots (KV caches
  only).
* ``check_serve_world`` checks that a ``Comm`` has one rank per group;
  ``make_sharded_decode`` is the per-group decode; ``SlotMigrator`` ships
  slot rows (K/V, recurrent state, positions) between ranks with
  ``distributed.migrate.migrate_items``, the fixed-capacity all_to_all
  executor of the FEM element migration.

All of them write the state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..distributed.migrate import migrate_items
from ..models.config import ModelConfig
from ..models.rglru import RGLRUCache
from ..models.ssm import SSMCache
from ..models.transformer import hybrid_layer_kinds
from .decode import (KV_FAMILIES, EncDecState, HybridState, KVCache,
                     SSMState, State, _kv_family, _served, decode_step)

# the slot axis of each field: k / v are (L, b, hkv, S, hd); positions
# and recurrent states carry the slot on axis 0, stacked ones on axis 1
_KV_AXES = KVCache(k=1, v=1, stored_pos=0, pos=0)
# a send buffer of one migration chunk stays under this many bytes (the
# rows of as many layers as fit; at least one layer a chunk)
MIGRATE_CHUNK_BYTES = 1 << 28


def slot_axes(cfg: ModelConfig):
    """The slot-axis index of each leaf, in a tree of the serving state's
    structure for ``cfg.family``."""
    if cfg.family in KV_FAMILIES:
        return _KV_AXES
    if cfg.family == "ssm":
        return SSMState(layers=SSMCache(state=1, conv=1), pos=0)
    if cfg.family == "hybrid":
        return HybridState(
            layers=tuple(_KV_AXES if kind == "attn"
                         else RGLRUCache(h=0, conv=0)
                         for kind in hybrid_layer_kinds(cfg)),
            pos=0)
    _served(cfg)
    return EncDecState(self_kv=_KV_AXES, cross_k=1, cross_v=1, pos=0)


def _leaves(x) -> list:
    """The leaves of a state (or axes) tree, dataclass fields and tuple
    items in order."""
    if dataclasses.is_dataclass(x):
        return [leaf for f in dataclasses.fields(x)
                for leaf in _leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def slot_nbytes(state: State, axes) -> int:
    """Bytes of one slot row across the state: the unit of the migration
    volume accounting."""
    return sum(leaf.numel() // leaf.shape[ax] * leaf.element_size()
               for leaf, ax in zip(_leaves(state), _leaves(axes)))


def n_slots_of(state: State, axes) -> int:
    """Slot-axis length of a state: the global slot count on one device,
    a rank's ``spg`` rows over a group."""
    leaf, ax = _leaves(state)[0], _leaves(axes)[0]
    return int(leaf.shape[ax])


def write_slot(state: State, row: State, slot: int, axes) -> State:
    """Overwrite row ``slot`` of ``state`` with the batch-1 state ``row``
    (a prefill state of the same ``max_seq``), in place (a row's values
    take the state's types: an ``act_dtype`` conv window lands exactly in
    a float32 one)."""
    for leaf, r, ax in zip(_leaves(state), _leaves(row), _leaves(axes)):
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

    def decode(model, state: State, tokens: torch.Tensor):
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


def _units(state: State, axes) -> Tuple[List[List[torch.Tensor]],
                                       List[torch.Tensor]]:
    """The migration payload of a state, as views with the slot axis
    first: one unit a layer (the layer's rows of every leaf stacked over
    the layers, or every leaf of one cache of a per-layer tuple) and the
    per-slot leaves outside the layers (positions)."""
    stacked: Dict[int, List[torch.Tensor]] = {}
    per_layer: List[List[torch.Tensor]] = []
    rest: List[torch.Tensor] = []

    def walk(x, ax):
        if isinstance(x, tuple):
            per_layer.extend([leaf.movedim(a, 0) for leaf, a in
                              zip(_leaves(c), _leaves(ca))]
                             for c, ca in zip(x, ax))
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), getattr(ax, f.name))
        elif ax == 0:
            rest.append(x)
        else:               # slot axis 1: stacked over the layers on axis 0
            for layer in range(x.shape[0]):
                stacked.setdefault(layer, []).append(x[layer])

    walk(state, axes)
    return [stacked[k] for k in sorted(stacked)] + per_layer, rest


class SlotMigrator:
    """Ship slot rows between the ranks of a group with the all_to_all
    executor.

    ``__call__(state, moves)`` with ``moves`` a sequence of ``(src_slot,
    dst_slot)`` global slot ids executes every move in one exchange (a
    destination slot may itself be vacated in the same round: each chunk's
    payload is read before its arrivals are written).  Every rank calls
    it with the same moves; ``state`` is the rank's own ``spg`` rows,
    updated in place.  Returns the state and the executor's volume
    scalars, summed over the ranks.

    The payload is every leaf's slot rows, slot axis first (K/V,
    recurrent state, conv windows, positions), weighted by the template's
    ``slot_nbytes`` (the reference's ``w_bytes``, taken once: a conv
    window that has turned float32 since ships more bytes than it
    weighs).  It is shipped in chunks of whole layers whose send buffer
    stays under ``chunk_bytes`` (at least one layer a chunk; the
    positions go with the first), with the same plan for every chunk, so
    the bits received equal one whole call's; the volume scalars come
    from the first chunk.  The fixed
    capacity ships ``groups * spg`` rows a call, moved or not: the bytes
    put on the exchange are counted in ``comm.all_to_all_bytes``."""

    def __init__(self, cfg: ModelConfig, comm, axes, state_template: State,
                 *, chunk_bytes: int = MIGRATE_CHUNK_BYTES):
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

    def _chunks(self, state: State) -> List[Dict[str, torch.Tensor]]:
        """Payload views, slot axis first: whole layers a chunk, the
        positions with the first."""
        units, rest = _units(state, self.axes)
        rows = self.groups * self.spg
        chunks: List[List[torch.Tensor]] = [[]]
        size = 0
        for unit in units:
            b = rows * sum(v[0].numel() * v.element_size() for v in unit)
            if chunks[-1] and size + b > self.chunk_bytes:
                chunks.append([])
                size = 0
            chunks[-1].extend(unit)
            size += b
        chunks[0].extend(rest)
        return [{str(i): v for i, v in enumerate(c)} for c in chunks]

    def __call__(self, state: State, moves: Sequence[Tuple[int, int]]
                 ) -> Tuple[State, Dict[str, float]]:
        if not moves:
            return state, {"moved_bytes": 0.0, "received_bytes": 0.0,
                           "n_moved": 0, "overflow": 0}
        dest, valid, recv = self.plan(moves)
        g, spg = self.groups, self.spg
        dev = _leaves(state)[0].device
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
