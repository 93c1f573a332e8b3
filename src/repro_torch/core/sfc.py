"""Space-filling-curve keys: Morton and Hilbert 3-D -> 1-D maps.

Paper section 2.2, as in ``repro.core.sfc``: PHG's aspect-preserving
bounding-box map (``uniform=True``) or Zoltan's per-axis one, then a
Morton bit interleave or Skilling's Hilbert transpose algorithm.

Keys are int64 tensors holding the JAX package's uint32 values.
``sfc_keys`` computes the box map in PyTorch and the keys through
``kernels.ops.sfc_keys_op``: the hand-written kernel on CUDA tensors,
the encoders below on CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

# Default bits per axis: 10 bits -> 2^30 distinct cells; keys fit in uint32.
DEFAULT_BITS = 10


# ---------------------------------------------------------------------------
# Bounding-box normalization (paper section 2.2)
# ---------------------------------------------------------------------------

def bounding_box(coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned bounding box of (n, 3) coordinates -> (lo, hi)."""
    return coords.amin(dim=0), coords.amax(dim=0)


def box_map(coords: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
            uniform: bool = True, bits: int = DEFAULT_BITS) -> torch.Tensor:
    """Map (n, 3) coords into the integer grid [0, 2^bits)^3 (int64).

    uniform=True  : PHG's map  x1 = (x - x0) / max_len  (locality preserving)
    uniform=False : Zoltan's map x1 = (x - x0) / len_x  (aspect distorting)

    The operation order -- ``(coords - lo) / scale * 2^bits``, floor,
    clip -- is the JAX package's, so float32 inputs give identical grids.
    """
    extent = hi - lo
    extent = torch.where(extent <= 0, torch.ones_like(extent), extent)
    if uniform:
        unit = (coords - lo) / extent.max()
    else:
        unit = (coords - lo) / extent
    n = (1 << bits) - 1
    grid = torch.clamp(torch.floor(unit * (1 << bits)), 0, n)
    return grid.to(torch.int64)


# ---------------------------------------------------------------------------
# Morton curve
# ---------------------------------------------------------------------------

def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so they occupy every 3rd bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by2."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton_encode(grid: torch.Tensor, bits: int = DEFAULT_BITS) -> torch.Tensor:
    """Morton key of int64 grid coords (n, 3) -> (n,) int64 (30-bit)."""
    if bits > 10:
        raise ValueError("30-bit Morton keys support bits<=10")
    x, y, z = grid[..., 0], grid[..., 1], grid[..., 2]
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def morton_decode(key: torch.Tensor, bits: int = DEFAULT_BITS) -> torch.Tensor:
    """Inverse of morton_encode -> (n, 3) grid coords."""
    return torch.stack([_compact1by2(key), _compact1by2(key >> 1),
                        _compact1by2(key >> 2)], dim=-1)


# ---------------------------------------------------------------------------
# Hilbert curve (Skilling's transpose algorithm, vectorized)
# ---------------------------------------------------------------------------

def _axes_to_transpose(X: torch.Tensor, bits: int) -> torch.Tensor:
    """Skilling AxesToTranspose: (n, 3) grid -> (n, 3) transpose form."""
    x0, x1, x2 = X[..., 0], X[..., 1], X[..., 2]
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        # i = 0: exchanging x0 with itself is an inversion when the bit is set
        x0 = torch.where((x0 & q) != 0, x0 ^ p, x0)
        for which in (1, 2):
            xi = x1 if which == 1 else x2
            cond = (xi & q) != 0
            t = (x0 ^ xi) & p
            new_x0 = torch.where(cond, x0 ^ p, x0 ^ t)
            new_xi = torch.where(cond, xi, xi ^ t)
            x0 = new_x0
            if which == 1:
                x1 = new_xi
            else:
                x2 = new_xi
        q >>= 1
    # Gray encode
    x1 = x1 ^ x0
    x2 = x2 ^ x1
    t = torch.zeros_like(x0)
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((x2 & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return torch.stack([x0 ^ t, x1 ^ t, x2 ^ t], dim=-1)


def _transpose_to_axes(X: torch.Tensor, bits: int) -> torch.Tensor:
    """Skilling TransposeToAxes (inverse of _axes_to_transpose)."""
    x0, x1, x2 = X[..., 0], X[..., 1], X[..., 2]
    t = x2 >> 1
    x2 = x2 ^ x1
    x1 = x1 ^ x0
    x0 = x0 ^ t
    q = 2
    while q != (1 << bits):
        p = q - 1
        for which in (2, 1, 0):
            xi = (x0, x1, x2)[which]
            cond = (xi & q) != 0
            if which == 0:
                x0 = torch.where(cond, x0 ^ p, x0)
                continue
            t2 = (x0 ^ xi) & p
            new_x0 = torch.where(cond, x0 ^ p, x0 ^ t2)
            new_xi = torch.where(cond, xi, xi ^ t2)
            x0 = new_x0
            if which == 1:
                x1 = new_xi
            else:
                x2 = new_xi
        q <<= 1
    return torch.stack([x0, x1, x2], dim=-1)


def _interleave_transpose(X: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack transpose form into one key: bit b of axis i -> key bit
    (3*b + (2-i))."""
    x0, x1, x2 = X[..., 0], X[..., 1], X[..., 2]
    key = torch.zeros_like(x0)
    for b in range(bits):
        key = key | (((x0 >> b) & 1) << (3 * b + 2))
        key = key | (((x1 >> b) & 1) << (3 * b + 1))
        key = key | (((x2 >> b) & 1) << (3 * b + 0))
    return key


def _deinterleave_transpose(key: torch.Tensor, bits: int) -> torch.Tensor:
    x0 = torch.zeros_like(key)
    x1 = torch.zeros_like(key)
    x2 = torch.zeros_like(key)
    for b in range(bits):
        x0 = x0 | (((key >> (3 * b + 2)) & 1) << b)
        x1 = x1 | (((key >> (3 * b + 1)) & 1) << b)
        x2 = x2 | (((key >> (3 * b + 0)) & 1) << b)
    return torch.stack([x0, x1, x2], dim=-1)


def hilbert_encode(grid: torch.Tensor, bits: int = DEFAULT_BITS) -> torch.Tensor:
    """Hilbert key of int64 grid coords (n, 3) -> (n,) int64 (30-bit)."""
    if bits > 10:
        raise ValueError("30-bit Hilbert keys support bits<=10")
    return _interleave_transpose(_axes_to_transpose(grid, bits), bits)


def hilbert_decode(key: torch.Tensor, bits: int = DEFAULT_BITS) -> torch.Tensor:
    """Inverse of hilbert_encode -> (n, 3) grid coords."""
    return _transpose_to_axes(_deinterleave_transpose(key, bits), bits)


# ---------------------------------------------------------------------------
# End-to-end: coordinates -> SFC keys
# ---------------------------------------------------------------------------

def sfc_keys(coords: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
             curve: str = "hilbert", uniform: bool = True,
             bits: int = DEFAULT_BITS,
             use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Coordinates (n, 3) -> SFC keys (n,) int64.

    curve   : 'hilbert' (PHG/HSFC) or 'morton' (MSFC)
    uniform : True = PHG aspect-preserving box map, False = Zoltan per-axis
    """
    from ..kernels import ops
    grid = box_map(coords, lo, hi, uniform=uniform, bits=bits)
    if curve not in ("hilbert", "morton"):
        raise ValueError(f"unknown curve {curve!r}")
    return ops.sfc_keys_op(grid, curve=curve, bits=bits, use_pallas=use_pallas)


# ---------------------------------------------------------------------------
# Incremental re-keying: cached keys against a frozen bounding box
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KeyCache:
    """SFC keys cached against a FROZEN bounding box (host arrays).

    Only dirty items re-key, in blocks, against the frozen box until the
    live box drifts more than ``drift_tol`` of the frozen extent; then
    every key is stale and a full re-key against the new box happens."""
    keys: np.ndarray                # (n,) int64
    lo: np.ndarray                  # (3,) frozen box corner, float32
    hi: np.ndarray                  # (3,)
    curve: str = "hilbert"
    uniform: bool = True
    bits: int = DEFAULT_BITS
    drift_tol: float = 0.05
    block: int = 128


def box_drift(lo_f: np.ndarray, hi_f: np.ndarray,
              lo: np.ndarray, hi: np.ndarray) -> float:
    """Max corner displacement relative to the frozen box extent."""
    extent = float(np.max(np.asarray(hi_f) - np.asarray(lo_f)))
    extent = extent if extent > 0 else 1.0
    move = max(float(np.max(np.abs(np.asarray(lo) - np.asarray(lo_f)))),
               float(np.max(np.abs(np.asarray(hi) - np.asarray(hi_f)))))
    return move / extent


def refresh_key_cache(cache: Optional[KeyCache], coords,
                      dirty: Optional[np.ndarray] = None, *,
                      curve: str = "hilbert", uniform: bool = True,
                      bits: int = DEFAULT_BITS, drift_tol: float = 0.05,
                      block: int = 128, device=None,
                      use_pallas: Optional[bool] = None
                      ) -> Tuple[KeyCache, Dict]:
    """Bring a :class:`KeyCache` up to date with ``coords`` (host array).

    A full re-key happens when the cache is absent, its parameters or
    length disagree, or the live bounding box drifted beyond
    ``drift_tol``; otherwise only the blocks holding dirty items re-key
    against the frozen box.  Keys are computed on ``device`` (default
    CUDA).  Returns ``(cache, info)`` with
    ``info = {mode, n_rekeyed, drift, n_blocks}``."""
    dev = resolve_device(device)
    coords_np = np.asarray(coords, np.float32)
    n = coords_np.shape[0]
    lo_now = coords_np.min(axis=0)
    hi_now = coords_np.max(axis=0)

    def keys_of(xyz: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        k = sfc_keys(torch.as_tensor(xyz, device=dev),
                     torch.as_tensor(lo, device=dev),
                     torch.as_tensor(hi, device=dev), curve=curve,
                     uniform=uniform, bits=bits, use_pallas=use_pallas)
        return k.cpu().numpy()

    def full():
        c = KeyCache(keys=keys_of(coords_np, lo_now, hi_now), lo=lo_now,
                     hi=hi_now, curve=curve, uniform=uniform, bits=bits,
                     drift_tol=drift_tol, block=block)
        return c, {"mode": "full", "n_rekeyed": n, "drift": drift,
                   "n_blocks": -(-n // block)}

    drift = 0.0
    if (cache is None or cache.keys.shape[0] != n or cache.curve != curve
            or cache.uniform != uniform or cache.bits != bits):
        return full()
    drift = box_drift(cache.lo, cache.hi, lo_now, hi_now)
    if drift > drift_tol:
        return full()

    if dirty is None:
        dirty_idx = np.empty(0, np.int64)
    else:
        dirty = np.asarray(dirty)
        dirty_idx = np.flatnonzero(dirty) if dirty.dtype == bool else dirty
    if dirty_idx.size == 0:
        return cache, {"mode": "delta", "n_rekeyed": 0, "drift": drift,
                       "n_blocks": 0}

    # whole blocks, the block count padded to a power of two (extra slots
    # recompute block 0: same values, harmless writes) -- the JAX
    # package's shape policy, kept so both re-key the same items
    blocks = np.unique(dirty_idx // block)
    nb = int(blocks.size)
    nb_pad = 1 << (nb - 1).bit_length()
    blocks = np.concatenate([blocks, np.zeros(nb_pad - nb, np.int64)])
    idx = (blocks[:, None] * block + np.arange(block)[None, :]).reshape(-1)
    idx = np.minimum(idx, n - 1)
    keys = cache.keys.copy()
    keys[idx] = keys_of(coords_np[idx], cache.lo, cache.hi)
    cache = dataclasses.replace(cache, keys=keys)
    return cache, {"mode": "delta", "n_rekeyed": int(nb * block),
                   "drift": drift, "n_blocks": nb}
