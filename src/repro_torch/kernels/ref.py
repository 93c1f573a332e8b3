"""Plain PyTorch versions of the hand-written kernels.

The CPU path of every kernel and the yardstick ``chip_smoke.py`` holds
each kernel against on the card.  Counterpart of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import partition1d as _p1d
from ..core import sfc as _sfc
from ..segment import segment_sum
from .fem_matvec import _MASS20, CHUNK
from .sfc_keys import ODD_START, hilbert_table


# --- sfc_keys --------------------------------------------------------------

def morton_keys_ref(grid: torch.Tensor, bits: int = 10) -> torch.Tensor:
    return _sfc.morton_encode(grid.to(torch.int64), bits)


def hilbert_keys_ref(grid: torch.Tensor, bits: int = 10) -> torch.Tensor:
    return _sfc.hilbert_encode(grid.to(torch.int64), bits)


def hilbert_keys_identities_ref(grid: torch.Tensor,
                                bits: int = 10) -> torch.Tensor:
    """Skilling's loop followed by the two identities that replace its
    tail: the Gray loop's ``t`` is the prefix XOR of ``x2 >> 1`` from the
    top, and the 30-step interleave is ``(spread(x0) << 2) | (spread(x1)
    << 1) | spread(x2)`` with the Morton ``spread``.  Used only by the
    tests, which hold it against the reference encoder."""
    g = grid.to(torch.int64)
    x0, x1, x2 = g[..., 0], g[..., 1], g[..., 2]
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        x0 = torch.where((x0 & q) != 0, x0 ^ p, x0)
        for which in (1, 2):
            xi = x1 if which == 1 else x2
            cond = (xi & q) != 0
            t = (x0 ^ xi) & p
            x0, xi = torch.where(cond, x0 ^ p, x0 ^ t), torch.where(
                cond, xi, xi ^ t)
            if which == 1:
                x1 = xi
            else:
                x2 = xi
        q >>= 1
    x1 = x1 ^ x0
    x2 = x2 ^ x1
    t = x2 >> 1
    for shift in (1, 2, 4, 8):
        t = t ^ (t >> shift)
    return ((_sfc._part1by2(x0 ^ t) << 2) | (_sfc._part1by2(x1 ^ t) << 1)
            | _sfc._part1by2(x2 ^ t))


def hilbert_keys_table_ref(grid: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """The kernel's table walk in plain torch: ``ceil(bits / 2)`` lookups
    of ``sfc_keys.hilbert_table``, two levels each, from the top (the
    odd-start row first where ``bits`` is odd).  Used only by the tests,
    which hold it against the reference encoder."""
    g = grid.to(torch.int64)
    table = torch.as_tensor(hilbert_table().astype(np.int64),
                            device=g.device)
    steps = (bits + 1) // 2
    row = torch.full(g.shape[:-1], 0 if bits % 2 == 0 else ODD_START * 64,
                     dtype=torch.int64, device=g.device)
    key = torch.zeros_like(row)
    for s in range(steps - 1, -1, -1):
        pair = (g >> (2 * s)) & 3
        e = table[row | (pair[..., 0] << 4) | (pair[..., 1] << 2)
                  | pair[..., 2]]
        key = (key << 6) | (e & 63)
        row = e & ~63
    return key


# --- prefix_scan -----------------------------------------------------------

def exclusive_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis (Algorithm 1's S_i)."""
    return torch.cumsum(x, dim=-1) - x


# --- ksection_hist ---------------------------------------------------------

def ksection_histogram_ref(keys: torch.Tensor, weights: torch.Tensor,
                           cuts: torch.Tensor) -> torch.Tensor:
    """Weight strictly below each candidate cut (cuts in any order):
    ``core.partition1d.weight_below`` in float32."""
    return _p1d.weight_below(keys, weights.to(torch.float32),
                             cuts.to(torch.float32))


def ksection_rank_ref(keys: torch.Tensor, weights: torch.Tensor,
                      cuts: torch.Tensor) -> torch.Tensor:
    """The kernel's formulation in plain torch: each cut's rank among
    the cuts' order-preserving bits (ties by index), each item's bucket
    ``#{cuts <= key}`` (``searchsorted(right=True)`` over the sorted
    cuts), the bucket sums, their inclusive prefix ``S`` and ``out[j] =
    S[rank_j]``.  Used only by the tests, which hold it against the JAX
    package's kernel."""
    f32 = torch.float32
    c, k, w = cuts.to(f32), keys.to(f32), weights.to(f32)
    m = c.shape[0]
    if m == 0:
        return torch.zeros(0, dtype=f32, device=c.device)
    bits = c.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF,
                          bits | 1 << 31)
    by_rank = torch.argsort(ordered, stable=True)
    rank = torch.empty_like(by_rank)
    rank[by_rank] = torch.arange(m, device=c.device)
    bucket = torch.searchsorted(c[by_rank].contiguous(), k.contiguous(),
                                right=True)
    hist = torch.zeros(m + 1, dtype=f32, device=c.device).index_add_(
        0, bucket, w)
    return torch.cumsum(hist[:m], dim=0)[rank]


# --- fem_matvec ------------------------------------------------------------

def fem_matvec_kel_ref(tets: torch.Tensor, kel: torch.Tensor,
                       u: torch.Tensor, n_out: int,
                       order=None) -> torch.Tensor:
    """The kernel's function on the kernel's inputs: gather the 4 vertex
    values (pad slot clamped to ``V - 1``), apply the precomputed 4x4
    ``K_e``, scatter-add into ``n_out`` slots (slot ``n_out`` dropped).
    ``order``: the ``segment.SegmentOrder`` of ``tets`` into ``n_out``
    where the caller keeps one (``ops.ElementOperator``)."""
    t = tets.long()
    ue = u[t.clamp(max=u.shape[0] - 1)]
    au = torch.einsum("cij,cj->ci", kel.to(u.dtype), ue)
    return segment_sum(au.reshape(-1), t.reshape(-1), n_out, order)


def fem_matvec_plan_ref(plan, kel: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """The kernel's two passes on its plan (``fem_matvec.ElementPlan``),
    in plain torch: ``kel`` in the plan's element order.  Row sums by
    slot, each local vertex's run of slots in the plan's order (one
    partial per kept local vertex), each vertex's partials in chunk
    order.  Held against the JAX package on the CPU, it shows that a plan
    routes every (element, corner) where the kernel needs it."""
    n_out, C = plan.n_out, plan.n_elems
    y = torch.zeros(n_out, dtype=u.dtype, device=u.device)
    if C == 0 or n_out == 0:
        return y
    dev = u.device
    chunk_off = plan.chunk_off.long()
    n_chunks = chunk_off.numel() - 1
    L = plan.gid.numel()
    chunk_of_lv = torch.repeat_interleave(torch.arange(n_chunks, device=dev),
                                          chunk_off.diff())
    us = u[plan.gid.long().clamp(max=u.shape[0] - 1)]
    elem_chunk = torch.arange(C, device=dev) // CHUNK
    ue = us[plan.local.long() + chunk_off[elem_chunk][:, None]]
    rs = torch.einsum("cij,cj->ci", kel.to(u.dtype), ue).reshape(-1)
    chunk_base = torch.arange(4 * C, device=dev) // (4 * CHUNK) * (4 * CHUNK)
    ends = plan.seg_end.long()
    first = torch.arange(L, device=dev) == chunk_off[chunk_of_lv]
    begins = torch.where(first, 0, torch.roll(ends, 1))
    lv_of_pos = torch.repeat_interleave(torch.arange(L, device=dev),
                                        ends - begins)
    sums = torch.zeros(L, dtype=u.dtype, device=dev).index_add_(
        0, lv_of_pos, rs[plan.inc.long() + chunk_base])
    kept = plan.pos >= 0
    partial = torch.zeros(plan.n_partials, dtype=u.dtype, device=dev)
    partial[plan.pos[kept].long()] = sums[kept]
    owner = torch.repeat_interleave(torch.arange(n_out, device=dev),
                                    plan.vert_off.long().diff())
    return y.index_add_(0, owner, partial)


def fem_matvec_ref(tets: torch.Tensor, grads: torch.Tensor, vol: torch.Tensor,
                   u: torch.Tensor, n_out: int, *, c: float = 0.0
                   ) -> torch.Tensor:
    """Geometry form of the element matvec (the JAX package's oracle):
    stiffness (+ ``c`` mass) einsums per call, masked scatter-add.
    ``tets``: (C, 4) slot ids in ``[0, n_out]``; ``u``: (V,), V >= n_out."""
    t = tets.long()
    mass = torch.as_tensor(_MASS20 / 20.0, dtype=grads.dtype,
                           device=grads.device)
    ue = u[t.clamp(max=u.shape[0] - 1)]
    flux = torch.einsum("cid,ci->cd", grads, ue)
    au = torch.einsum("cjd,cd->cj", grads, flux) * vol[:, None]
    if c != 0.0:
        au = au + c * torch.einsum("ij,cj->ci", mass, ue) * vol[:, None]
    return segment_sum(au.reshape(-1), t.reshape(-1), n_out)


# --- flash_attention -------------------------------------------------------

def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int | None = None,
            scale: float | None = None) -> torch.Tensor:
    """Reference attention.  q: (b, hq, s, d), k/v: (b, hkv, s_kv, d).

    GQA: query head h reads kv head h // (hq // hkv).  float32 softmax.
    ``window``: key j visible from query i iff i - window < j (combined
    with causal: j <= i).  The mask is built from both lengths, so s_kv
    may differ from s (cross-attention, no mask)."""
    b, hq, s, d = q.shape
    s_kv = k.shape[2]
    group = hq // k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    f32 = torch.float32
    kq = k.repeat_interleave(group, dim=1).to(f32)
    vq = v.repeat_interleave(group, dim=1).to(f32)
    logits = torch.einsum("bhid,bhjd->bhij", q.to(f32), kq) * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s_kv, device=q.device)[None, :]
    mask = torch.ones((s, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    logits = torch.where(mask[None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, vq).to(q.dtype)


# --- serve_prefill ---------------------------------------------------------

def packed_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         seg: torch.Tensor, *, softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Segment-masked causal attention over one packed prefill buffer.

    q: (hq, C, d); k/v: (hkv, C, d); seg: (C,) int32 request ids, -1 =
    pad.  Key j is visible from query i iff j <= i and seg[i] == seg[j]
    >= 0.  Rows that see no key (pad rows) are exactly 0.  float32
    softmax; GQA by repeat, like ``mha_ref``."""
    hq, C, d = q.shape
    group = hq // k.shape[0]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    f32 = torch.float32
    kq = k.repeat_interleave(group, dim=0).to(f32)
    vq = v.repeat_interleave(group, dim=0).to(f32)
    logits = torch.einsum("hid,hjd->hij", q.to(f32), kq) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    i = torch.arange(C, device=q.device)
    seg = seg.to(q.device)
    mask = ((i[None, :] <= i[:, None]) & (seg[:, None] == seg[None, :])
            & (seg[:, None] >= 0))
    logits = torch.where(mask[None], logits, -1e30)
    p = torch.where(mask[None], torch.softmax(logits, dim=-1), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("hij,hjd->hid", p, vq)
    out = torch.where(l > 0.0, out, 0.0)
    return out.to(q.dtype)
