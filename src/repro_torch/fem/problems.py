"""The paper's two numerical examples as registered problem definitions.

Example 3.1: Helmholtz with Dirichlet BCs on the long cylinder
    -Delta u + u = f,   u = cos(2 pi x) cos(2 pi y) cos(2 pi z)
    => f = (12 pi^2 + 1) u.

Example 3.2: linear parabolic problem on (0,1)^3 with the paper's moving
peak  u = exp(1 / (25 r^2 + 0.9) - 2.5),  r^2 = |x - c(t)|^2,
c(t) = (1/2 + 2/5 sin 8 pi t, 1/2 + 2/5 cos 8 pi t, 1).

Counterpart of ``repro.fem.problems``.  Functions take torch tensors; the
parabolic source ``f = u_t - Delta u`` is written out analytically where
the JAX package differentiates automatically.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

TWO_PI = 2.0 * math.pi

PROBLEM_KINDS = ("stationary", "parabolic")


@dataclass(frozen=True)
class ProblemSetup:
    """Everything the adaptive session needs to run one named problem:
    the problem object, its kind (selects the solve variant), a default
    mesh factory, and the paper's marking defaults."""
    name: str
    kind: str                              # 'stationary' | 'parabolic'
    make: Callable[[], Any]                # () -> problem object
    default_mesh: Callable[[], Any]        # () -> repro_torch.fem.mesh.Mesh
    theta: float = 0.5
    coarsen_frac: float = 0.0
    max_tets: int = 200_000

    def __post_init__(self):
        if self.kind not in PROBLEM_KINDS:
            raise ValueError(f"unknown problem kind {self.kind!r}; "
                             f"choose from {PROBLEM_KINDS}")


_PROBLEMS: Dict[str, ProblemSetup] = {}


def register_problem(setup: ProblemSetup) -> ProblemSetup:
    """Register (or replace) a named problem setup."""
    _PROBLEMS[setup.name] = setup
    return setup


def get_problem(name: str) -> ProblemSetup:
    try:
        return _PROBLEMS[name]
    except KeyError:
        raise ValueError(f"unknown problem {name!r}; "
                         f"registered: {problem_names()}") from None


def problem_names():
    return sorted(_PROBLEMS)


# ---------------------------------------------------------------------------
# Example 3.1 -- Helmholtz
# ---------------------------------------------------------------------------

def helmholtz_exact(x: torch.Tensor) -> torch.Tensor:
    return (torch.cos(TWO_PI * x[..., 0]) * torch.cos(TWO_PI * x[..., 1])
            * torch.cos(TWO_PI * x[..., 2]))


def helmholtz_f(x: torch.Tensor) -> torch.Tensor:
    return (12.0 * math.pi ** 2 + 1.0) * helmholtz_exact(x)


@dataclass
class HelmholtzProblem:
    """-Delta u + c u = f ;  c = 1."""
    c: float = 1.0
    exact: Callable = staticmethod(helmholtz_exact)
    f: Callable = staticmethod(helmholtz_f)


# ---------------------------------------------------------------------------
# Example 3.2 -- parabolic moving peak
# ---------------------------------------------------------------------------

def _peak_centre(t: float):
    return (0.5 + 0.4 * math.sin(8.0 * math.pi * t),
            0.5 + 0.4 * math.cos(8.0 * math.pi * t))


def peak_exact(x: torch.Tensor, t: float) -> torch.Tensor:
    cx, cy = _peak_centre(t)
    r2 = ((x[..., 0] - cx) ** 2 + (x[..., 1] - cy) ** 2
          + (x[..., 2] - 1.0) ** 2)
    return torch.exp(1.0 / (25.0 * r2 + 0.9) - 2.5)


def peak_f(x: torch.Tensor, t: float) -> torch.Tensor:
    """f = u_t - Delta u.  With g = 1/D - 2.5, D = 25 r^2 + 0.9, u = e^g:
    u_t = u g_t, Delta u = u (|grad g|^2 + Delta g),
    grad g = -50 (x - c) / D^2, Delta g = -150 / D^2 + 5000 r^2 / D^3."""
    cx, cy = _peak_centre(t)
    dcx = 0.4 * 8.0 * math.pi * math.cos(8.0 * math.pi * t)
    dcy = -0.4 * 8.0 * math.pi * math.sin(8.0 * math.pi * t)
    dx, dy, dz = x[..., 0] - cx, x[..., 1] - cy, x[..., 2] - 1.0
    r2 = dx * dx + dy * dy + dz * dz
    D = 25.0 * r2 + 0.9
    u = torch.exp(1.0 / D - 2.5)
    g_t = (-25.0 / D ** 2) * (-2.0 * dx * dcx - 2.0 * dy * dcy)
    grad2 = 2500.0 * r2 / D ** 4
    lap_g = -150.0 / D ** 2 + 5000.0 * r2 / D ** 3
    return u * (g_t - grad2 - lap_g)


@dataclass
class ParabolicProblem:
    """u_t - Delta u = f, backward Euler, paper's moving peak."""
    t_end: float = 1.0
    exact: Callable = staticmethod(peak_exact)
    f: Callable = staticmethod(peak_f)


# ---------------------------------------------------------------------------
# Registrations: the paper's two examples
# ---------------------------------------------------------------------------

def _helmholtz_mesh():
    from .mesh import cylinder_mesh
    return cylinder_mesh(8, 2, length=4.0, radius=0.5)


def _parabolic_mesh():
    from .mesh import unit_cube_mesh
    return unit_cube_mesh(3)


register_problem(ProblemSetup(
    name="helmholtz", kind="stationary", make=HelmholtzProblem,
    default_mesh=_helmholtz_mesh, theta=0.5, coarsen_frac=0.0,
    max_tets=200_000))

register_problem(ProblemSetup(
    name="parabolic", kind="parabolic", make=ParabolicProblem,
    default_mesh=_parabolic_mesh, theta=0.4, coarsen_frac=0.15,
    max_tets=120_000))
