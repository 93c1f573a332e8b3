"""Jacobi-preconditioned CG on the device.

Solves (A + c M) u = b with Dirichlet dofs pinned.  ``pcg`` also runs
on owned-layout vertex vectors over a process group (``vdot`` hook,
``owned_vdot``; ``fem.parallel.sharded_solve_dirichlet``).  The
operator is the hand-written element-matvec kernel
(``kernels.ops.ElementOperator``) on element matrices and a plan of the
mesh built once per solve; the loop is a Python loop whose stopping test
reads one scalar from the device per iteration.
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
        maxiter: int = 2000,
        vdot: Optional[Callable[[torch.Tensor, torch.Tensor],
                                torch.Tensor]] = None) -> CGResult:
    """Standard PCG with Jacobi preconditioner M = diag.

    ``vdot`` generalizes the inner product so the same loop runs on
    sharded vertex vectors: with the owned layout each rank holds its
    (V,) slots, shared vertices on every toucher, and ``vdot`` is the
    ownership-masked local sum plus one scalar psum (``owned_vdot``).
    Norms then come from the same ``vdot``.  Default: ``torch.dot`` and
    the vector norm (replicated vectors)."""
    inv_d = torch.where(diag > 0, 1.0 / diag, torch.zeros_like(diag))
    if vdot is None:
        dot, norm = torch.dot, torch.linalg.vector_norm
    else:
        dot = vdot

        def norm(v):
            return torch.sqrt(torch.clamp(dot(v, v), min=0.0))

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


def owned_vdot(owned_mask: torch.Tensor, comm) -> Callable:
    """Inner product for owned-layout (V,) vertex vectors on one rank.

    Shared vertices live on every toucher; masking by ownership counts
    each dof once, so the result equals the replicated ``torch.dot`` up
    to summation order: a local masked sum and one scalar psum."""
    def dot(a, b):
        return comm.psum(torch.where(owned_mask, a * b, 0.0).sum())
    return dot


def element_operator(el: P1Elements, c: float, *,
                     use_pallas: Optional[bool] = None) -> ops.ElementOperator:
    """The element operator of ``(A + c M)`` on ``el``: element matrices
    built once, and on the card the kernel's plan of the mesh."""
    return ops.ElementOperator(el.tets, fem_element_matrices(el.grads, el.vol,
                                                             c),
                               el.n_verts, use_pallas=use_pallas,
                               order=el.order)


def masked_operator(el: P1Elements, free: torch.Tensor, c: float, *,
                    element_op: Optional[ops.ElementOperator] = None,
                    use_pallas: Optional[bool] = None
                    ) -> Tuple[Callable, torch.Tensor]:
    """Operator restricted to free dofs (Dirichlet rows/cols zeroed,
    identity on pinned dofs) + its diagonal.  ``element_op`` applies
    ``(A + c M)`` (built here when not given)."""
    if element_op is None:
        element_op = element_operator(el, c, use_pallas=use_pallas)

    def op(u):
        au = element_op.apply(u * free)
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
    (solve for w = u - g_ext with homogeneous BCs).  The element operator
    (element matrices, and the kernel's plan on the card) is built once
    and serves the lift and every PCG matvec."""
    element_op = element_operator(el, c, use_pallas=use_pallas)
    g_ext = torch.where(free > 0, torch.zeros_like(g), g)
    lift = element_op.apply(g_ext)
    b = torch.where(free > 0, rhs - lift, torch.zeros_like(rhs))
    op, diag = masked_operator(el, free, c, element_op=element_op)
    res = pcg(op, b, diag, torch.zeros_like(b), tol=tol, maxiter=maxiter)
    return CGResult(res.x + g_ext, res.iters, res.residual)
