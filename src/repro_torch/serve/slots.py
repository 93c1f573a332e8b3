"""KV-cache slots: layout, slot writes and the paged insert of the packed
prefill.  Counterpart of ``repro/serve/slots.py`` on one device.

The serving state is a ``decode.KVCache`` whose batch dimension is the
global slot axis (``spec.total_slots`` rows).  ``slot_axes`` names that
axis for each field; ``write_slot`` merges a batch-1 prefill cache into
one slot; ``make_paged_insert`` scatters a packed prefill's K/V into many
slots page by page.  All of them write in place.

The group mesh, the sharded decode and ``SlotMigrator`` (the all-to-all
KV migration) need the multi-device layer (ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from .decode import KVCache, _dense_only

MESH_TODO = ("a group mesh (sharded decode, KV migration) needs the "
             "multi-device layer (ROADMAP.md, queue 1, item 9)")

# the slot axis of each field: k / v are (L, b, hkv, S, hd)
_KV_AXES = KVCache(k=1, v=1, stored_pos=0, pos=0)


def slot_axes(cfg: ModelConfig) -> KVCache:
    """Slot-axis index of each field of the serving state."""
    _dense_only(cfg)
    return _KV_AXES


def _fields(x):
    return [getattr(x, f.name) for f in dataclasses.fields(x)]


def slot_nbytes(state: KVCache, axes: KVCache) -> int:
    """Bytes of one slot row across the state: the unit of the migration
    volume accounting."""
    return sum(leaf.numel() // leaf.shape[ax] * leaf.element_size()
               for leaf, ax in zip(_fields(state), _fields(axes)))


def write_slot(state: KVCache, row: KVCache, slot: int, axes: KVCache
               ) -> KVCache:
    """Overwrite global slot ``slot`` of ``state`` with the batch-1 state
    ``row`` (a prefill cache of the same ``max_seq``), in place."""
    for leaf, r, ax in zip(_fields(state), _fields(row), _fields(axes)):
        idx = (slice(None),) * ax
        leaf[idx + (slot,)] = r[idx + (0,)]
    return state


def make_paged_insert(cfg: ModelConfig, mesh=None, *, total_slots: int,
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

    The reference scatters with ``mode='drop'``, which silently drops
    out-of-range indices; torch indexing raises instead, so the pages are
    masked explicitly.  Returns ``insert(state, pk, pv, page_slot,
    page_dst, written, slen)``, which updates ``state`` in place."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)
    _dense_only(cfg)
    n_pages = capacity // page_size

    def insert(state: KVCache, pk, pv, page_slot, page_dst, written, slen
               ) -> KVCache:
        L, sl, hkv, S, hd = state.k.shape
        sp_pages = S // page_size
        keep = ((page_slot >= 0) & (page_slot < sl)
                & (page_dst >= 0) & (page_dst < sp_pages))
        ls, pd = page_slot[keep].long(), page_dst[keep].long()
        k6 = state.k.view(L, sl, hkv, sp_pages, page_size, hd)
        v6 = state.v.view(L, sl, hkv, sp_pages, page_size, hd)
        # advanced indices (ls, pd) separated by a slice: the indexed view
        # is (P, L, hkv, page_size, hd), the advanced dim first
        k6[:, ls, :, pd] = pk.view(L, hkv, n_pages, page_size, hd
                                   ).movedim(2, 0)[keep]
        v6[:, ls, :, pd] = pv.view(L, hkv, n_pages, page_size, hd
                                   ).movedim(2, 0)[keep]
        iota = torch.arange(S, dtype=torch.int32, device=state.k.device)[None]
        fresh = torch.where(iota < slen[:, None], iota, -1)
        state.stored_pos.copy_(torch.where(written[:, None], fresh,
                                           state.stored_pos))
        state.pos.copy_(torch.where(written, slen, state.pos))
        return state

    return insert
