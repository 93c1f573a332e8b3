"""Adaptive FEM substrate (the paper's host application) in PyTorch.

``AdaptSpec`` describes the solve -> estimate -> mark -> refine/coarsen ->
balance loop and ``AdaptiveSession`` runs it on one device, or on one
rank per part of a process group (``backend='sharded'``: ``halo`` and
``parallel`` hold the owned-vertex exchange and the distributed
operators).  The old ``solve_*_adaptive`` drivers are deprecated thin
wrappers over the session.
"""
from .adapt import (ADAPT_STAGES, TRIGGERS, AdaptSpec, AdaptiveResult,
                    AdaptiveSession, SessionState, StepStats,
                    adapt_stage_variants, get_adapt_stage, peak_init,
                    register_adapt_stage, resolve_adapt_variants,
                    solve_helmholtz_adaptive, solve_parabolic_adaptive,
                    transfer_p1)
from .assemble import (P1Elements, build_elements, element_gradients,
                       load_vector, mass_matvec, operator_diagonal,
                       stiffness_matvec)
from .estimate import doerfler_mark, threshold_coarsen_mark, zz_estimate
from .halo import HaloPlan, build_halo_plan, halo_reduce, update_halo_plan
from .mesh import Mesh, cylinder_mesh, kuhn_box_mesh, unit_cube_mesh
from .problems import (HelmholtzProblem, ParabolicProblem, ProblemSetup,
                       get_problem, problem_names, register_problem)
from .refine import coarsen, refine, uniform_refine
from .solve import CGResult, owned_vdot, pcg, solve_dirichlet
