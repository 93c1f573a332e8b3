"""Wrapper of the hand-written SFC-key kernel (``csrc/sfc_keys.cu``), and
the Hilbert table it walks.

Replaces the TPU kernel ``repro/kernels/sfc_keys.py::sfc_keys_pallas``.
Its plain version is ``kernels.ref.morton_keys_ref`` / ``hilbert_keys_ref``
(the encoders of ``core.sfc``); ``kernels.ops.sfc_keys_op`` chooses.

The Hilbert encoder as a finite-state transducer (``hilbert_table``):
each level of Skilling's AxesToTranspose loop, read from the top, maps
the lower bits of the three axes by an axis permutation and per-axis
inversions that depend on the level's three coordinate bits as the map
so far sees them, and the Gray encoding carries one bit of parity down
(the prefix XOR of the Gray-coded third axis).  The state is that map
and the parity: 48 states are reachable from the identity.  The table
covers two levels per lookup.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import build

CURVES = {"morton": 0, "hilbert": 1}

#: rows of the two-level table: the 48 states, then the row that starts
#: an odd number of levels (a virtual top level of zeros)
HILBERT_STATES = 48
ODD_START = HILBERT_STATES

_State = Tuple[Tuple[int, int, int], Tuple[int, int, int], int]
_IDENTITY: _State = ((0, 1, 2), (0, 0, 0), 0)


def _hilbert_level(state: _State, d: Tuple[int, int, int]
                   ) -> Tuple[int, _State]:
    """One level of Skilling's loop and the Gray encoding, for the level's
    coordinate bits ``d`` (axes 0, 1, 2).

    ``state`` = (perm, flips, parity): the lower bits as the loop so far
    has mapped them, axis i reading original axis ``perm[i]`` inverted
    where ``flips[i]``; ``parity``, the XOR of the Gray-coded third axis
    over the levels above.  Returns the key's 3-bit digit for the level
    (axis 0 in the top bit) and the state for the level below."""
    perm, flips, parity = state
    e = [d[perm[i]] ^ flips[i] for i in range(3)]
    low = [(perm[i], flips[i]) for i in range(3)]
    if e[0]:                       # x0 ^= p
        low[0] = (low[0][0], low[0][1] ^ 1)
    for i in (1, 2):
        if e[i]:                   # x0 ^= p
            low[0] = (low[0][0], low[0][1] ^ 1)
        else:                      # swap the lower bits of x0 and x_i
            low[0], low[i] = low[i], low[0]
    g0, g1 = e[0], e[0] ^ e[1]
    g2 = g1 ^ e[2]
    digit = ((g0 ^ parity) << 2) | ((g1 ^ parity) << 1) | (g2 ^ parity)
    nxt = (tuple(a for a, _ in low), tuple(f for _, f in low), parity ^ g2)
    return digit, nxt


def _bits_of(v: int) -> Tuple[int, int, int]:
    return (v >> 2) & 1, (v >> 1) & 1, v & 1


@functools.lru_cache(maxsize=None)
def hilbert_states() -> Tuple[List[_State], Dict[_State, int]]:
    """The states reachable from the identity, in discovery order (the
    identity is state 0), and their indices."""
    states, index = [_IDENTITY], {_IDENTITY: 0}
    i = 0
    while i < len(states):
        for v in range(8):
            _, nxt = _hilbert_level(states[i], _bits_of(v))
            if nxt not in index:
                index[nxt] = len(states)
                states.append(nxt)
        i += 1
    return states, index


@functools.lru_cache(maxsize=None)
def hilbert_table() -> np.ndarray:
    """(49 * 64,) int16 two-level table: entry ``row * 64 + idx``, with
    ``idx = (x0 pair << 4) | (x1 pair << 2) | x2 pair`` the two levels'
    coordinate bits (higher level in each pair's top bit), holds
    ``next * 64 + (hi digit << 3 | lo digit)``.  Row ``ODD_START``
    reads a pair whose top level is a virtual 0 and continues from the
    identity."""
    states, index = hilbert_states()
    if len(states) != HILBERT_STATES:
        raise AssertionError(f"{len(states)} Hilbert states, expected "
                             f"{HILBERT_STATES}")
    table = np.zeros((HILBERT_STATES + 1) * 64, np.int16)
    for idx in range(64):
        hi = ((idx >> 5) & 1, (idx >> 3) & 1, (idx >> 1) & 1)
        lo = ((idx >> 4) & 1, (idx >> 2) & 1, idx & 1)
        for row, state in enumerate(states):
            dh, mid = _hilbert_level(state, hi)
            dl, nxt = _hilbert_level(mid, lo)
            table[row * 64 + idx] = index[nxt] * 64 + (dh << 3 | dl)
        if not any(hi):
            dl, nxt = _hilbert_level(_IDENTITY, lo)
            table[ODD_START * 64 + idx] = index[nxt] * 64 + dl
    return table


_tables: Dict[torch.device, torch.Tensor] = {}


def _table_on(device: torch.device) -> torch.Tensor:
    if device not in _tables:
        _tables[device] = torch.as_tensor(hilbert_table(), device=device)
    return _tables[device]


def sfc_keys_cuda(grid: torch.Tensor, *, curve: str = "hilbert",
                  bits: int = 10) -> torch.Tensor:
    """(n, 3) int32 grid coordinates on a CUDA device -> (n,) int32 keys.

    Coordinates must lie in ``[0, 2^bits)``; ``bits <= 10`` (30-bit
    keys).  The grid may start at any 4-byte offset (a contiguous slice
    of a larger tensor runs too, with narrower loads).  Adds one to
    ``sfc_keys_cuda.launches`` per launch."""
    if not grid.is_cuda:
        raise ValueError(f"sfc_keys_cuda needs a CUDA tensor, got {grid.device}")
    if (grid.dtype != torch.int32 or grid.dim() != 2 or grid.shape[1] != 3
            or not grid.is_contiguous()):
        raise ValueError("sfc_keys_cuda needs a contiguous (n, 3) int32 grid, "
                         f"got {tuple(grid.shape)} {grid.dtype}")
    if curve not in CURVES:
        raise ValueError(f"unknown curve {curve!r}; choose from {tuple(CURVES)}")
    if not 1 <= bits <= 10:
        raise ValueError(f"bits must be in [1, 10], got {bits}")
    n = grid.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=grid.device)
    if n == 0:
        return out
    table = _table_on(grid.device)
    sms = torch.cuda.get_device_properties(grid.device).multi_processor_count
    lib = build.library()
    with torch.cuda.device(grid.device):
        err = lib.repro_sfc_keys(grid.data_ptr(), out.data_ptr(), n,
                                 CURVES[curve], bits, table.data_ptr(), sms,
                                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "sfc_keys")
    sfc_keys_cuda.launches += 1
    return out


sfc_keys_cuda.launches = 0
