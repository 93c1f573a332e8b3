"""Element matrices and the wrapper of the hand-written P1 element-matvec
kernel (``csrc/fem_matvec.cu``).

Replaces the TPU kernel ``repro/kernels/fem_matvec.py::fem_matvec_pallas``.
Its plain version is ``kernels.ref.fem_matvec_kel_ref`` (gather, 4x4 apply,
masked ``index_add_``); ``kernels.ops.fem_matvec_op`` chooses.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

# P1 reference-tet mass matrix scaled by 20 (integer-exact; the caller
# multiplies by vol/20) -- the same constant as fem.assemble's mass matrix.
_MASS20 = np.full((4, 4), 1.0, np.float64) + np.eye(4)


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


def fem_matvec_cuda(tets: torch.Tensor, kel: torch.Tensor, u: torch.Tensor,
                    n_out: int) -> torch.Tensor:
    """Element matvec on a CUDA device: (n_out,) float32 contributions.

    ``tets``: (C, 4) int32 slot ids in ``[0, n_out]`` (slot ``n_out`` is
    dropped); ``kel``: (C, 4, 4) float32 element matrices; ``u``: (V,)
    float32 with ``V >= max(n_out, 1)``, read at ``min(t, V - 1)``.  Adds
    one to ``fem_matvec_cuda.launches`` per launch."""
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
    if tets.data_ptr() % 16 or kel.data_ptr() % 16:
        raise ValueError("fem_matvec_cuda: tets and kel must be 16-byte aligned")
    if not tets.device == kel.device == u.device:
        raise ValueError("tets, kel and u must be on one device")
    if C == 0:
        return torch.zeros(n_out, dtype=torch.float32, device=u.device)
    y = torch.empty(n_out, dtype=torch.float32, device=u.device)
    lib = build.library()
    with torch.cuda.device(u.device):
        err = lib.repro_fem_matvec(tets.data_ptr(), kel.data_ptr(), C,
                                   u.data_ptr(), V, y.data_ptr(), n_out,
                                   torch.cuda.current_stream().cuda_stream)
    build.check(err, "fem_matvec")
    fem_matvec_cuda.launches += 1
    return y


fem_matvec_cuda.launches = 0
