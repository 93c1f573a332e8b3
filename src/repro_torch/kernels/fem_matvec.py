"""Element matrices, the element-operator plan and the wrapper of the
hand-written P1 element-matvec kernel (``csrc/fem_matvec.cu``).

Replaces the TPU kernel ``repro/kernels/fem_matvec.py::fem_matvec_pallas``.
Its plain version is ``kernels.ref.fem_matvec_kel_ref`` (gather, 4x4 apply,
masked ``index_add_``); ``kernels.ops.fem_matvec_op`` and
``kernels.ops.ElementOperator`` choose.

The kernel sums without atomics, in an order fixed by the mesh, so it
needs a plan of the mesh (``build_element_plan``): built once from the
connectivity and reused by every matvec of a solve.  The elements are cut
into chunks of ``CHUNK`` consecutive elements; the chunk's distinct
vertices are its *local vertices*, and each (chunk, local vertex) pair
below ``n_out`` is one *partial* sum.  Pass 1 of the kernel (one CTA per
chunk) computes every partial; pass 2 sums each vertex's partials in
chunk order.  Consecutive elements of the mesh's own order share
vertices (refinement writes the children in place of their parent), so a
chunk of 256 elements has ~110 local vertices and the partials number
~0.4 per element.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import build

# P1 reference-tet mass matrix scaled by 20 (integer-exact; the caller
# multiplies by vol/20) -- the same constant as fem.assemble's mass matrix.
_MASS20 = np.full((4, 4), 1.0, np.float64) + np.eye(4)

#: elements per chunk: one CTA of the kernel's first pass (csrc CHUNK,
#: which ``fem_matvec_cuda`` checks against this)
CHUNK = 256


def fem_element_matrices(grads: torch.Tensor, vol: torch.Tensor,
                         c: float = 0.0) -> torch.Tensor:
    """Per-element 4x4 operator ``K_e = (grad_j . grad_i + c M_ji) |e|``.

    ``grads``: (..., C, 4, 3), ``vol``: (..., C) -> (..., C, 4, 4).
    Constant across the matvecs of one solve: build once, stream per
    call.  Padding elements (grads = 0, vol = 0) get K_e = 0."""
    k = torch.einsum("...cid,...cjd->...cij", grads, grads)
    if c != 0.0:
        mass = torch.as_tensor(_MASS20 / 20.0, dtype=k.dtype, device=k.device)
        k = k + c * mass
    return k * vol[..., None, None]


class ElementPlan(NamedTuple):
    """The kernel's plan of one connectivity (C elements, slots < n_out
    kept).  Slot ``q = 4 e + i`` is corner i of element e; chunk k holds
    elements ``[k CHUNK, (k + 1) CHUNK)`` and slots ``[4 k CHUNK, ...)``.
    Local vertices are numbered chunk by chunk, ascending vertex id within
    a chunk (L in all)."""
    n_elems: int
    n_out: int
    local: torch.Tensor       # (C, 4) int16: each corner's local vertex
    inc: torch.Tensor         # (4C,) int16: each chunk's slots, chunk-
                              # relative, ordered by (local vertex, slot)
    chunk_off: torch.Tensor   # (n_chunks + 1,) int32: first local vertex
    gid: torch.Tensor         # (L,) int32: vertex id of each local vertex
    seg_end: torch.Tensor     # (L,) int16: end of its run in ``inc``
    pos: torch.Tensor         # (L,) int32: index of its partial; -1 for
                              # ids >= n_out (the dropped pad slot)
    vert_off: torch.Tensor    # (n_out + 1,) int32: vertex -> partials CSR,
                              # each vertex's partials in chunk order
    n_partials: int


def build_element_plan(tets: torch.Tensor, n_out: int) -> ElementPlan:
    """The plan of ``tets`` ((C, 4) ids in ``[0, 2^31)``; ids >= n_out
    are dropped from the output) on ``tets``' device, in plain torch: two
    stable sorts (slots by (chunk, vertex); partials by (vertex, chunk))
    and a few gathers and scans."""
    dev = tets.device
    i16, i32, i64 = torch.int16, torch.int32, torch.int64
    C = int(tets.shape[0])
    n_chunks = -(-C // CHUNK)
    if C == 0:
        z = torch.zeros(0, dtype=i32, device=dev)
        return ElementPlan(0, n_out, torch.zeros((0, 4), dtype=i16,
                                                 device=dev),
                           z.to(i16), torch.zeros(1, dtype=i32, device=dev),
                           z, z.to(i16), z,
                           torch.zeros(n_out + 1, dtype=i32, device=dev), 0)
    slots = torch.arange(4 * C, device=dev)
    chunk_of = slots // (4 * CHUNK)
    key = (chunk_of << 32) | tets.reshape(-1).to(i64)
    order = torch.argsort(key, stable=True)      # (chunk, vertex, slot)
    sk = key[order]
    first = torch.ones(4 * C, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    starts = torch.nonzero(first).squeeze(1)
    lchunk = sk[starts] >> 32
    gid = sk[starts] & 0xFFFFFFFF
    chunk_off = torch.zeros(n_chunks + 1, dtype=i64, device=dev)
    chunk_off[1:] = torch.cumsum(torch.bincount(lchunk, minlength=n_chunks), 0)
    # sorted position p lies in chunk chunk_of[p] too (the chunk is the
    # major key and every chunk has 4 CHUNK slots but the last)
    lv = torch.cumsum(first, 0) - 1
    local = torch.empty(4 * C, dtype=i16, device=dev)
    local[order] = (lv - chunk_off[chunk_of]).to(i16)
    inc = (order - chunk_of * (4 * CHUNK)).to(i16)
    ends = torch.cat([starts[1:], starts.new_tensor([4 * C])])
    seg_end = (ends - lchunk * (4 * CHUNK)).to(i16)
    kept = gid < n_out
    porder = torch.argsort(torch.where(kept, gid, n_out), stable=True)
    rank = torch.empty_like(porder)
    rank[porder] = torch.arange(porder.numel(), device=dev)
    pos = torch.where(kept, rank, -1).to(i32)
    counts = torch.bincount(gid[kept], minlength=n_out)
    vert_off = torch.zeros(n_out + 1, dtype=i64, device=dev)
    vert_off[1:] = torch.cumsum(counts, 0)
    return ElementPlan(C, n_out, local.reshape(C, 4), inc,
                       chunk_off.to(i32), gid.to(i32), seg_end, pos,
                       vert_off.to(i32), int(vert_off[-1]))


def fem_matvec_cuda(tets: torch.Tensor, kel: torch.Tensor, u: torch.Tensor,
                    n_out: int, *, plan: Optional[ElementPlan] = None
                    ) -> torch.Tensor:
    """Element matvec on a CUDA device: (n_out,) float32 contributions.

    ``tets``: (C, 4) int32 slot ids in ``[0, n_out]`` (slot ``n_out`` is
    dropped); ``kel``: (C, 4, 4) float32 element matrices; ``u``: (V,)
    float32 with ``V >= max(n_out, 1)``, read at ``min(t, V - 1)``.
    ``plan``: ``build_element_plan(tets, n_out)``, built once for many
    calls (``ops.ElementOperator`` keeps one); without it a plan is built
    for this call alone.  Bit-identical from call to call.  Adds one to
    ``fem_matvec_cuda.launches`` per launch."""
    for name, t, dt in (("tets", tets, torch.int32), ("kel", kel, torch.float32),
                        ("u", u, torch.float32)):
        if not t.is_cuda:
            raise ValueError(f"fem_matvec_cuda needs CUDA tensors; {name} is "
                             f"on {t.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"fem_matvec_cuda: {name} must be contiguous "
                             f"{dt}, got {t.dtype}")
    C = tets.shape[0]
    if tets.shape != (C, 4) or kel.shape != (C, 4, 4) or u.dim() != 1:
        raise ValueError(f"fem_matvec_cuda: bad shapes tets {tuple(tets.shape)}"
                         f", kel {tuple(kel.shape)}, u {tuple(u.shape)}")
    V = u.shape[0]
    if V < max(n_out, 1):
        raise ValueError(f"fem_matvec_cuda: u has {V} entries, needs at least "
                         f"max(n_out, 1) = {max(n_out, 1)}")
    if kel.data_ptr() % 16:
        raise ValueError("fem_matvec_cuda: kel must be 16-byte aligned")
    if not tets.device == kel.device == u.device:
        raise ValueError("tets, kel and u must be on one device")
    if C == 0 or n_out == 0:
        return torch.zeros(n_out, dtype=torch.float32, device=u.device)
    if plan is None:
        plan = build_element_plan(tets, n_out)
    if (plan.n_elems, plan.n_out) != (C, n_out) or plan.gid.device != u.device:
        raise ValueError(f"fem_matvec_cuda: the plan is of {plan.n_elems} "
                         f"elements and n_out {plan.n_out} on "
                         f"{plan.gid.device}, not {C} and {n_out}")
    y = torch.empty(n_out, dtype=torch.float32, device=u.device)
    partial = torch.empty(max(plan.n_partials, 1), dtype=torch.float32,
                          device=u.device)
    lib = build.library()
    if lib.repro_fem_matvec_chunk() != CHUNK:
        raise RuntimeError(f"fem_matvec_cuda: the kernel's chunk is "
                           f"{lib.repro_fem_matvec_chunk()} elements, the "
                           f"plan's {CHUNK}")
    with torch.cuda.device(u.device):
        err = lib.repro_fem_matvec(
            kel.data_ptr(), plan.local.data_ptr(), plan.inc.data_ptr(),
            plan.chunk_off.data_ptr(), plan.gid.data_ptr(),
            plan.seg_end.data_ptr(), plan.pos.data_ptr(), C, u.data_ptr(), V,
            partial.data_ptr(), plan.vert_off.data_ptr(), y.data_ptr(), n_out,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "fem_matvec")
    fem_matvec_cuda.launches += 1
    return y


fem_matvec_cuda.launches = 0
