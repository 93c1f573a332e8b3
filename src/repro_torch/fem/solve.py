"""Jacobi-preconditioned CG on the device.

Solves (A + c M) u = b with Dirichlet dofs pinned.  The operator is the
hand-written element-matvec kernel (``kernels.ops.fem_matvec_op``) on
element matrices built once per solve; the loop is a Python loop whose
stopping test reads one scalar from the device per iteration.
Counterpart of ``repro.fem.solve``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..kernels import ops
from ..kernels.fem_matvec import fem_element_matrices
from .assemble import P1Elements, operator_diagonal


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        diag: torch.Tensor, x0: torch.Tensor, *, tol: float = 1e-8,
        maxiter: int = 2000) -> CGResult:
    """Standard PCG with Jacobi preconditioner M = diag."""
    inv_d = torch.where(diag > 0, 1.0 / diag, torch.zeros_like(diag))
    dot, norm = torch.dot, torch.linalg.vector_norm

    x = x0
    r = b - matvec(x0)
    z = r * inv_d
    p = z
    rz = dot(r, z)
    bnorm = torch.clamp(norm(b), min=1e-30)
    it = 0
    while it < maxiter and bool(norm(r) > tol * bnorm):
        ap = matvec(p)
        alpha = rz / torch.clamp(dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = r * inv_d
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return CGResult(x, it, norm(r) / bnorm)


def masked_operator(el: P1Elements, free: torch.Tensor, c: float, *,
                    kel: Optional[torch.Tensor] = None,
                    use_pallas: Optional[bool] = None
                    ) -> Tuple[Callable, torch.Tensor]:
    """Operator restricted to free dofs (Dirichlet rows/cols zeroed,
    identity on pinned dofs) + its diagonal.  ``kel`` are the element
    matrices of ``(A + c M)`` (built here when not given)."""
    if kel is None:
        kel = fem_element_matrices(el.grads, el.vol, c)

    def op(u):
        au = ops.fem_matvec_op(el.tets, kel, u * free, el.n_verts,
                               use_pallas=use_pallas)
        return torch.where(free > 0, au, u)

    diag = torch.where(free > 0, operator_diagonal(el, c),
                       torch.ones_like(free))
    return op, diag


def solve_dirichlet(el: P1Elements, rhs: torch.Tensor, g: torch.Tensor,
                    free: torch.Tensor, c: float, *, tol: float = 1e-8,
                    maxiter: int = 2000,
                    use_pallas: Optional[bool] = None) -> CGResult:
    """Solve (A + cM) u = rhs with u = g on pinned dofs.

    ``rhs`` is the raw load vector; the boundary lift is applied here
    (solve for w = u - g_ext with homogeneous BCs).  The element matrices
    are built once and serve the lift and every PCG matvec."""
    kel = fem_element_matrices(el.grads, el.vol, c)
    g_ext = torch.where(free > 0, torch.zeros_like(g), g)
    lift = ops.fem_matvec_op(el.tets, kel, g_ext, el.n_verts,
                             use_pallas=use_pallas)
    b = torch.where(free > 0, rhs - lift, torch.zeros_like(rhs))
    op, diag = masked_operator(el, free, c, kel=kel, use_pallas=use_pallas)
    res = pcg(op, b, diag, torch.zeros_like(b), tol=tol, maxiter=maxiter)
    return CGResult(res.x + g_ext, res.iters, res.residual)
