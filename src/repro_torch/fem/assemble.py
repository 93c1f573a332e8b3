"""P1 Lagrange FEM assembly on tets -- matrix-free, in PyTorch.

The operator is applied element-wise (gather dofs -> local 4x4 apply ->
scatter-add), so assembly is a pair of segment sums and the "matrix" is
per-element geometry.  Counterpart of ``repro.fem.assemble``, float32
throughout (the JAX package runs with x64 off).  The PCG solve applies the
stiffness operator through the hand-written element-matvec kernel
(``fem.solve``); the rest stays plain PyTorch.

Weak forms: Helmholtz a(u,v) = int grad u . grad v + c u v, and the
backward-Euler parabolic step (M/dt + A).  Dirichlet BCs by masking.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..segment import segment_sum


class P1Elements(NamedTuple):
    """Per-element geometry for matrix-free P1 operators (device tensors)."""
    tets: torch.Tensor    # (nt, 4) int32 vertex ids
    grads: torch.Tensor   # (nt, 4, 3) gradients of the 4 basis functions
    vol: torch.Tensor     # (nt,) element volumes
    n_verts: int


def build_elements(verts: np.ndarray, tets: np.ndarray,
                   device=None) -> P1Elements:
    """P1 gradients + volumes, on ``device`` (default CUDA).  Vertices are
    cast to float32 first, as the JAX package's ``jnp.asarray`` does."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(tets), device=dev).long()
    x = v[t]                                             # (nt, 4, 3)
    b = (x[:, 1:] - x[:, :1]).transpose(1, 2)            # columns = edges
    vol = torch.linalg.det(b).abs() / 6.0
    # grad lam_i . e_j = delta_ij  =>  grad lam_i = row i of b^{-1}
    binv = torch.linalg.inv(b)
    g0 = -binv.sum(dim=1, keepdim=True)
    grads = torch.cat([g0, binv], dim=1)                 # (nt, 4, 3)
    return P1Elements(t.to(torch.int32), grads, vol, int(verts.shape[0]))


def _mass(dtype, device) -> torch.Tensor:
    """P1 mass matrix on the reference tet: V/10 diag, V/20 off-diag."""
    return (torch.full((4, 4), 1.0 / 20.0, dtype=dtype, device=device)
            + torch.eye(4, dtype=dtype, device=device) * (1.0 / 20.0))


# degree-2 quadrature on the tet (4 interior points, weights V/4)
_QA, _QB = 0.5854101966249685, 0.13819660112501053
_QPTS = np.array([[_QA, _QB, _QB, _QB], [_QB, _QA, _QB, _QB],
                  [_QB, _QB, _QA, _QB], [_QB, _QB, _QB, _QA]])  # barycentric


def stiffness_matvec(el: P1Elements, u: torch.Tensor,
                     c: float = 0.0) -> torch.Tensor:
    """(A + c M) u, matrix-free (geometry form, plain PyTorch)."""
    t = el.tets.long()
    ue = u[t]
    flux = torch.einsum("tid,ti->td", el.grads, ue)
    au = torch.einsum("tjd,td->tj", el.grads, flux) * el.vol[:, None]
    if c != 0.0:
        au = au + c * torch.einsum("ij,tj->ti", _mass(u.dtype, u.device),
                                   ue) * el.vol[:, None]
    return segment_sum(au.reshape(-1), t.reshape(-1), el.n_verts)


def mass_matvec(el: P1Elements, u: torch.Tensor) -> torch.Tensor:
    t = el.tets.long()
    mu = torch.einsum("ij,tj->ti", _mass(u.dtype, u.device),
                      u[t]) * el.vol[:, None]
    return segment_sum(mu.reshape(-1), t.reshape(-1), el.n_verts)


def operator_diagonal(el: P1Elements, c: float = 0.0) -> torch.Tensor:
    """diag(A + c M) for Jacobi preconditioning."""
    d = torch.einsum("tid,tid->ti", el.grads, el.grads) * el.vol[:, None]
    if c != 0.0:
        d = d + c * (1.0 / 10.0) * el.vol[:, None]
    return segment_sum(d.reshape(-1), el.tets.reshape(-1), el.n_verts)


def load_vector(el: P1Elements, verts: torch.Tensor,
                f: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """int f v_i with the 4-point degree-2 rule."""
    t = el.tets.long()
    xe = verts[t]                                        # (nt, 4, 3)
    q = torch.as_tensor(_QPTS, dtype=xe.dtype, device=xe.device)
    xq = torch.einsum("qb,tbd->tqd", q, xe)              # (nt, 4pts, 3)
    fq = f(xq.reshape(-1, 3)).reshape(xq.shape[:2])      # (nt, 4pts)
    contrib = torch.einsum("tq,qi->ti", fq, q) * (el.vol[:, None] / 4.0)
    return segment_sum(contrib.reshape(-1), t.reshape(-1), el.n_verts)


def element_gradients(el: P1Elements, u: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant grad u_h per element, (nt, 3)."""
    return torch.einsum("tid,ti->td", el.grads, u[el.tets.long()])
