"""The paper's DLB step written plainly: SFC keys, the k-section search,
the Oliker--Biswas remap and the migration metrics.

Two uses.  ``hilbert_keys`` and ``greedy_perm`` serve the judge
(``bench.check``), which holds the program's outputs against exact
sums.  ``balance`` is the whole step in one floating type: in float32 it
is the plain version of what the program computes; in bfloat16 it is the
control, the reference put in the program's place one precision below
the configuration's float32, which the judge has to refuse.

Every step follows the paper (section 2): a PHG box map (aspect
preserving) onto a 2^bits grid, Skilling's Hilbert transpose, a
k-section search over the float keys with the weight strictly below
each candidate cut, parts by ``#{splitters <= key}``, then the greedy
relabelling that keeps the most weight, guarded by the identity.
"""
from __future__ import annotations

import types
from typing import Optional

import numpy as np
import torch

BITS = 10
#: items a block of the key computation handles at once (bounds memory)
KEY_BLOCK = 1 << 23


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def box_grid(coords: torch.Tensor, bits: int = BITS) -> torch.Tensor:
    """(n, 3) coordinates -> int64 grid in [0, 2^bits)^3, PHG's map:
    ``(x - lo) / max extent``, times 2^bits, floor, clip, in the
    coordinates' own type."""
    lo, hi = coords.amin(dim=0), coords.amax(dim=0)
    extent = hi - lo
    extent = torch.where(extent <= 0, torch.ones_like(extent), extent)
    out = torch.empty(coords.shape, dtype=torch.int64, device=coords.device)
    top = (1 << bits) - 1
    scale = extent.max()
    for s in range(0, coords.shape[0], KEY_BLOCK):
        unit = (coords[s:s + KEY_BLOCK] - lo) / scale
        out[s:s + KEY_BLOCK] = torch.clamp(torch.floor(unit * (1 << bits)),
                                           0, top).to(torch.int64)
    return out


def _hilbert_block(x0, x1, x2, bits):
    """Skilling's AxesToTranspose, the Gray code and the interleave of
    the transpose's bits (axis 0 highest within each level)."""
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
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
    x1 = x1 ^ x0
    x2 = x2 ^ x1
    t = torch.zeros_like(x0)
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((x2 & q) != 0, t ^ (q - 1), t)
        q >>= 1
    x0, x1, x2 = x0 ^ t, x1 ^ t, x2 ^ t
    key = torch.zeros_like(x0)
    for b in range(bits):
        key |= ((x0 >> b) & 1) << (3 * b + 2)
        key |= ((x1 >> b) & 1) << (3 * b + 1)
        key |= ((x2 >> b) & 1) << (3 * b)
    return key


def hilbert_keys(grid: torch.Tensor, bits: int = BITS) -> torch.Tensor:
    """(n, 3) int64 grid -> (n,) int64 Hilbert keys (3 * bits bits)."""
    out = torch.empty(grid.shape[0], dtype=torch.int64, device=grid.device)
    for s in range(0, grid.shape[0], KEY_BLOCK):
        g = grid[s:s + KEY_BLOCK]
        out[s:s + KEY_BLOCK] = _hilbert_block(g[:, 0], g[:, 1], g[:, 2], bits)
    return out


# ---------------------------------------------------------------------------
# the k-section search
# ---------------------------------------------------------------------------

def weight_below(kf: torch.Tensor, w: torch.Tensor,
                 cuts: torch.Tensor) -> torch.Tensor:
    """Weight of the items with key < cut, for cuts in any order, summed
    in ``w``'s type: bucket by searchsorted, add, prefix."""
    order = torch.argsort(cuts, stable=True)
    cs = cuts[order].contiguous()
    # float32 holds every value of the narrower types exactly
    bucket = torch.searchsorted(cs.float(), kf.float(), right=True)
    hist = torch.zeros(cuts.shape[0] + 1, dtype=w.dtype, device=w.device)
    hist.index_add_(0, bucket, w)
    below = torch.cumsum(hist, dim=0)[:-1]
    out = torch.empty_like(below)
    out[order] = below
    return out.to(cuts.dtype)


def _candidates(blo, bhi, frac):
    """``blo + (bhi - blo) * frac`` rounded once into the boxes' type."""
    f64 = torch.float64
    return (blo.to(f64)[:, None] + (bhi - blo).to(f64)[:, None]
            * frac.to(f64)[None, :]).to(blo.dtype)


def ksection(kf, w, p, *, k, iters, warm=None):
    """Splitters of the k-section search (paper section 2.3) and the
    rounds run.  ``kf``: float keys in the boxes' type; ``w``: weights in
    the sums' type; ``warm``: the previous step's splitters or None."""
    fdt, dev = kf.dtype, kf.device
    total = w.sum().to(fdt)
    targets = total * torch.arange(1, p, dtype=fdt, device=dev) / p
    lo, hi = kf.min(), kf.max() + 1

    def hist(cuts):
        return weight_below(kf, w, cuts)

    if warm is not None:
        prev = torch.sort(warm.to(fdt)).values
        nlo = torch.clamp(torch.cat([lo[None], prev[:-1]]), lo, hi)
        nhi = torch.clamp(torch.cat([prev[1:], hi[None]]), lo, hi)
        m = (nhi - nlo) * torch.tensor(1.0 / (k + 1) ** 2, dtype=fdt,
                                       device=dev)
        tlo, thi = torch.clamp(prev - m, lo, hi), torch.clamp(prev + m, lo, hi)
        q = p - 1
        below = hist(torch.cat([tlo, thi, nlo, nhi]))
        t_ok = ((thi > tlo) & (below[:q] <= targets)
                & (below[q:2 * q] > targets))
        n_ok = ((nhi > nlo) & (below[2 * q:3 * q] <= targets)
                & (below[3 * q:] > targets))
        blo = torch.where(t_ok, tlo, torch.where(n_ok, nlo, lo))
        bhi = torch.where(t_ok, thi, torch.where(n_ok, nhi, hi))
    else:
        blo, bhi = lo.expand(p - 1).clone(), hi.expand(p - 1).clone()
    frac = torch.arange(1, k + 1, dtype=fdt, device=dev) / (k + 1)
    prev_w = torch.full_like(targets, float("inf"))
    rounds = 0
    while rounds < iters:
        width = bhi - blo
        if not bool(((width > 0) & (width < prev_w)).any()):
            break
        cand = _candidates(blo, bhi, frac)
        below = hist(cand.reshape(-1)).reshape(p - 1, k)
        le = below <= targets[:, None]
        new_lo = torch.where(le.any(dim=1), torch.where(
            le, cand, torch.tensor(float("-inf"), dtype=fdt, device=dev)
        ).amax(dim=1), blo)
        new_hi = torch.where((~le).any(dim=1), torch.where(
            ~le, cand, torch.tensor(float("inf"), dtype=fdt, device=dev)
        ).amin(dim=1), bhi)
        prev_w = bhi - blo
        blo, bhi = torch.maximum(new_lo, blo), torch.minimum(new_hi, bhi)
        rounds += 1
    return torch.sort(blo).values, rounds


# ---------------------------------------------------------------------------
# the remap
# ---------------------------------------------------------------------------

def greedy_perm(S: np.ndarray) -> np.ndarray:
    """Oliker--Biswas greedy on a square similarity matrix: take the
    largest entry whose row and column are both free, ties to the first
    in row-major order; perm[j] = process given new part j."""
    p = S.shape[0]
    order = np.argsort(-S, axis=None, kind="stable")
    perm = np.full(p, -1, np.int64)
    used = np.zeros(p, bool)
    left = p
    for f in order:
        i, j = divmod(int(f), p)
        if perm[j] < 0 and not used[i]:
            perm[j], used[i] = i, True
            left -= 1
            if not left:
                break
    return perm


def retained_of(S: np.ndarray, perm: np.ndarray) -> float:
    """Weight kept in place when new part j goes to process perm[j]."""
    return float(S[perm, np.arange(S.shape[0])].sum())


# ---------------------------------------------------------------------------
# the whole step in one floating type
# ---------------------------------------------------------------------------

def balance(coords: torch.Tensor, weights: torch.Tensor,
            old_parts: Optional[torch.Tensor], p: int, *, k: int, iters: int,
            warm: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.float32, bits: int = BITS):
    """One repartition, every float in ``dtype``: coordinates, keys as
    floats, weights, sums and the search's boxes.  Returns what the
    program's ``BalanceResult`` carries."""
    xyz = coords.to(dtype)
    w = weights.to(dtype)
    keys = hilbert_keys(box_grid(xyz, bits), bits)
    kf = keys.to(dtype)
    splitters, rounds = ksection(kf, w, p, k=k, iters=iters, warm=warm)
    new = torch.searchsorted(splitters.float().contiguous(),
                             kf.float().contiguous(), right=True)
    dev = coords.device
    perm = torch.arange(p, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    total_v = max_v = retained = zero
    if old_parts is not None:
        S = torch.zeros(p * p, dtype=dtype, device=dev).index_add_(
            0, old_parts * p + new, w).reshape(p, p)
        greedy = torch.as_tensor(greedy_perm(S.double().cpu().numpy()),
                                 device=dev)
        ar = torch.arange(p, device=dev)
        if torch.trace(S) <= S[greedy, ar].sum():
            perm = greedy
        new = perm[new]
        moved = old_parts != new
        moved_w = torch.where(moved, w, zero)
        out_w = torch.zeros(p, dtype=dtype, device=dev).index_add_(
            0, old_parts, moved_w)
        in_w = torch.zeros(p, dtype=dtype, device=dev).index_add_(
            0, new, moved_w)
        total_v = moved_w.sum()
        max_v = torch.maximum(out_w.max(), in_w.max())
        retained = torch.where(moved, zero, w).sum()
    pw = torch.zeros(p, dtype=dtype, device=dev).index_add_(0, new, w)
    return types.SimpleNamespace(
        parts=new, part_weights=pw, imbalance=pw.max() / pw.mean(),
        total_v=total_v, max_v=max_v, retained=retained, remap_perm=perm,
        splitters=splitters, ksection_rounds=rounds)
