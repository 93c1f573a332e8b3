"""Declarative adaptive-FEM engine: ``AdaptSpec`` + ``AdaptiveSession``.

The paper's computation model per adaptive step:

    solve -> estimate -> mark -> refine(/coarsen) -> **balance** -> repeat

Counterpart of ``repro.fem.adapt``.  The host backend runs on one device
(the card, by default); the sharded backend runs one rank per part over
a ``torch.distributed`` process group (``comm=``):

* ``AdaptSpec``       -- the JAX package's frozen spec (same fields,
  validation and plain-dict round trip, nested ``BalanceSpec``).  It names
  no device.
* stage registry      -- loop stages per ``(stage, variant)``: ``solve``
  ('stationary' | 'backward_euler', and the '_owned' twins that run
  distributed PCG on owner-sharded vertices through the halo exchange),
  ``estimate`` ('zz'), ``mark`` ('doerfler'), ``adapt_mesh`` ('refine' |
  'coarsen_refine'), ``transfer`` ('p1'), ``balance`` ('host' |
  'sharded').
* ``AdaptiveSession`` -- runs the loop on ``device`` (default CUDA; no
  fallback to the CPU), times each stage with a clock that waits for the
  device, and emits one ``StepStats`` per step.
* ``solve_helmholtz_adaptive`` / ``solve_parabolic_adaptive`` -- the
  deprecated driver functions, thin wrappers over the session.

The mesh and its refinement stay on the host (numpy, the JAX package's
order); element geometry, the solve (PCG over the hand-written
element-matvec kernel), the estimator and the balancer (SFC-key,
k-section histogram and prefix-scan kernels) run on the device.

``backend='sharded'``: the host mesh, with refinement, estimate and mark,
is replicated on every rank and kept identical (the solution and the
error indicators are broadcast from rank 0, since the card's atomic sums
may differ in the last bits between ranks).  The balance stage runs the
sharded ``Balancer`` and then re-packs the element payloads across the
ranks with the migration executor's ``all_to_all``.  With
``vertex_layout='owned'`` the ``HaloPlan`` is rebuilt from every new
partition, connectivity is renumbered to part-local slots during the
same migration, the solve is the owned-vertex PCG, and the per-matvec
communication model (replicated psum bytes against halo bytes, and the
cut) lands in each step's stats.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, ClassVar, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import deprecation, telemetry
from ..core import Balancer, BalanceSpec, imbalance
from ..core.metrics import cut_links
from ..core.sfc import refresh_key_cache
from ..core.spec import SFC_METHODS, Spec
from ..device import resolve_device
from .assemble import build_elements, load_vector, mass_matvec
from .estimate import doerfler_mark, threshold_coarsen_mark, zz_estimate
from .mesh import TET_FACES, Mesh
from .problems import ParabolicProblem, ProblemSetup, get_problem
from .refine import coarsen, refine
from .solve import solve_dirichlet

ADAPT_STAGES = ("solve", "estimate", "mark", "adapt_mesh", "transfer",
                "balance")
TRIGGERS = ("imbalance", "always", "never")
ADAPT_BACKENDS = ("host", "sharded")
VERTEX_LAYOUTS = ("replicated", "owned")


# ---------------------------------------------------------------------------
# Per-step records
# ---------------------------------------------------------------------------

@dataclass
class StepStats:
    n_tets: int
    n_verts: int
    eta: float
    err_l2: Optional[float]
    cg_iters: int
    t_solve: float
    t_estimate: float
    t_refine: float
    t_balance: float
    imbalance: float
    repartitioned: bool
    migration_totalv: float = 0.0
    cut: Optional[int] = None
    migration_retained: float = 0.0
    t_transfer: float = 0.0
    # communication-volume model per matvec (vertex_layout='owned' only):
    # replicated-path psum bytes vs halo-exchange bytes; cut above is the
    # surface index the halo bytes scale with
    comm_psum_bytes: int = 0
    comm_halo_bytes: int = 0
    # split-matvec phase times (owned layout, recorded under tracing):
    # interface pass + halo exchange vs the interior pass that hides it
    t_matvec_interior: float = 0.0
    t_matvec_halo: float = 0.0


@dataclass
class AdaptiveResult:
    stats: List[StepStats] = field(default_factory=list)
    n_repartitions: int = 0
    u: Optional[torch.Tensor] = None
    mesh: Optional[Mesh] = None
    # backend='sharded': this rank's latest element packing
    sharded: Optional[object] = None
    # vertex_layout='owned': the HaloPlan matching ``sharded``
    halo: Optional[object] = None
    spec: Optional["AdaptSpec"] = None


# ---------------------------------------------------------------------------
# AdaptSpec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdaptSpec(Spec):
    """Declarative description of one adaptive solve.

    problem            registered problem name ('helmholtz', 'parabolic')
    theta              Dörfler bulk-marking fraction
    coarsen_frac       time-dependent loop: coarsen elements with
                       ``eta < coarsen_frac * mean(eta)`` before refining
    estimate, mark     stage variant names
    solve              solve variant; 'auto' resolves from the problem kind
    trigger            repartition policy: 'imbalance' (the paper's),
                       'always', or 'never' (partition once)
    imbalance_trigger  threshold of the 'imbalance' trigger
    balance            nested ``BalanceSpec`` (its backend is overridden)
    backend            'host' (one device) | 'sharded' (one rank per part
                       over a process group: the sharded balancer and
                       the all_to_all element migration every step)
    vertex_layout      'replicated' | 'owned' (sharded backend only):
                       'owned' shards vertices by owner part and solves
                       with the halo-exchange PCG
    incremental        cached SFC keys (only dirty leaves re-key against a
                       frozen box) and warm-started k-section search
    max_steps          stationary: adaptive iterations
    max_tets           stop refining beyond this many elements
    dt, n_steps        backward-Euler time stepping (dt == 0: stationary)
    tol, maxiter       PCG stopping criteria
    """
    problem: str = "helmholtz"
    theta: float = 0.5
    coarsen_frac: float = 0.0
    estimate: str = "zz"
    mark: str = "doerfler"
    solve: str = "auto"
    trigger: str = "imbalance"
    imbalance_trigger: float = 1.05
    balance: BalanceSpec = BalanceSpec(p=16, method="hsfc")
    backend: str = "host"
    vertex_layout: str = "replicated"
    incremental: bool = False
    max_steps: int = 10
    max_tets: int = 200_000
    dt: float = 0.0
    n_steps: int = 0
    tol: float = 1e-8
    maxiter: int = 2000

    _NESTED_SPECS: ClassVar[Mapping[str, type]] = {"balance": BalanceSpec}

    def __post_init__(self):
        if not isinstance(self.balance, BalanceSpec):
            raise ValueError("balance must be a BalanceSpec (got "
                             f"{type(self.balance).__name__})")
        if self.trigger not in TRIGGERS:
            raise ValueError(f"unknown trigger {self.trigger!r}; "
                             f"choose from {TRIGGERS}")
        if self.backend not in ADAPT_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choose from {ADAPT_BACKENDS}")
        if self.vertex_layout not in VERTEX_LAYOUTS:
            raise ValueError(
                f"unknown vertex_layout {self.vertex_layout!r}; "
                f"choose from {VERTEX_LAYOUTS}")
        if self.vertex_layout == "owned" and self.backend != "sharded":
            raise ValueError("vertex_layout='owned' needs backend='sharded' "
                             "(the halo exchange lives on the device mesh)")
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"theta must be in (0, 1], got {self.theta}")
        if self.coarsen_frac < 0.0:
            raise ValueError("coarsen_frac must be >= 0")
        if self.dt < 0.0:
            raise ValueError("dt must be >= 0 (0 means stationary)")
        if self.dt > 0.0 and self.n_steps < 1:
            raise ValueError("time-dependent spec (dt > 0) needs n_steps >= 1")
        if self.dt == 0.0 and self.n_steps != 0:
            raise ValueError("n_steps is only meaningful with dt > 0; "
                             "stationary specs use max_steps")
        if self.dt == 0.0 and self.max_steps < 1:
            raise ValueError("max_steps must be >= 1")

    @property
    def stationary(self) -> bool:
        return self.dt == 0.0

    @property
    def p(self) -> int:
        """Number of parts (from the nested spec)."""
        return self.balance.p

    @classmethod
    def for_problem(cls, name: str, **overrides) -> "AdaptSpec":
        """Spec seeded from a registered problem's paper defaults
        (``theta`` / ``coarsen_frac`` / ``max_tets``; parabolic problems
        also ``trigger='always'``, ``dt=0.01``, ``n_steps=20``)."""
        setup = get_problem(name)
        kw: Dict[str, Any] = dict(problem=name, theta=setup.theta,
                                  coarsen_frac=setup.coarsen_frac,
                                  max_tets=setup.max_tets)
        if setup.kind == "parabolic":
            kw.update(trigger="always", dt=0.01, n_steps=20)
        kw.update(overrides)
        return cls(**kw)


# ---------------------------------------------------------------------------
# Stage registry
# ---------------------------------------------------------------------------

_ADAPT_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def register_adapt_stage(stage: str, variant: str) -> Callable:
    """Decorator: register a loop-stage function under ``(stage, variant)``.
    Stage functions take ``(session, state)`` and mutate the state."""
    if stage not in ADAPT_STAGES:
        raise ValueError(f"unknown adapt stage {stage!r}; "
                         f"choose from {ADAPT_STAGES}")

    def deco(fn):
        _ADAPT_REGISTRY[(stage, variant)] = fn
        return fn
    return deco


def get_adapt_stage(stage: str, variant: str) -> Callable:
    try:
        return _ADAPT_REGISTRY[(stage, variant)]
    except KeyError:
        avail = adapt_stage_variants(stage)
        raise ValueError(
            f"no {stage!r} stage variant {variant!r} registered; "
            f"available: {avail}") from None


def adapt_stage_variants(stage: str):
    """Registered variant names for an adapt-loop stage."""
    return sorted(v for (s, v) in _ADAPT_REGISTRY if s == stage)


def resolve_adapt_variants(spec: AdaptSpec,
                           setup: Optional[ProblemSetup] = None
                           ) -> Dict[str, Optional[str]]:
    """Map a spec to the stage variants its loop uses (``transfer`` is
    ``None`` for stationary problems)."""
    if setup is None:
        setup = get_problem(spec.problem)
    solve = spec.solve
    if solve == "auto":
        solve = ("stationary" if setup.kind == "stationary"
                 else "backward_euler")
        if spec.backend == "sharded" and spec.vertex_layout == "owned":
            solve += "_owned"
    stationary = setup.kind == "stationary"
    return {
        "solve": solve,
        "estimate": spec.estimate,
        "mark": spec.mark,
        "adapt_mesh": "refine" if stationary else "coarsen_refine",
        "transfer": None if stationary else "p1",
        "balance": spec.backend,
    }


# ---------------------------------------------------------------------------
# Session state
# ---------------------------------------------------------------------------

@dataclass
class SessionState:
    """Mutable per-run state threaded through the stage functions."""
    mesh: Mesh
    step: int = 0
    t: float = 0.0                      # physical time (time-dependent)
    el: Any = None                      # P1Elements of the current mesh
    u: Any = None                       # nodal solution (device tensor)
    eta: Optional[np.ndarray] = None    # per-element error indicators
    marked: Optional[np.ndarray] = None
    active_before: Optional[np.ndarray] = None   # pre-refine vertex mask
    grew: bool = True
    cg_iters: int = 0
    err_l2: Optional[float] = None
    repartitioned: bool = False
    step_imbalance: float = float("nan")
    migration_totalv: float = 0.0
    migration_retained: float = 0.0
    balance_result: Any = None          # core.BalanceResult of last repart
    sharded: Any = None                 # this rank's ShardedElements
    halo: Any = None                    # HaloPlan matching `sharded` (owned)
    # connectivity/partition snapshots `halo` was built from, so the
    # incremental session can rebuild the next plan from the delta
    packed_tets: Optional[np.ndarray] = None
    packed_parts: Optional[np.ndarray] = None
    halo_info: Optional[Dict] = None    # how the last HaloPlan was produced
    key_info: Optional[Dict] = None     # how the last SFC keys were produced
    mesh_version: int = 0               # bumped by every mesh mutation
    packed_version: int = -1            # mesh_version `sharded` was packed at
    packed_ntets: int = -1              # n_tets `sharded` was packed for
    balanced_step: int = -1             # step _balance_common last ran on
    owned_ops: Dict[float, Any] = field(default_factory=dict)  # c -> (mv, diag)
    cut: Optional[int] = None           # surface index of current partition
    comm_psum_bytes: int = 0            # per-matvec comm model (owned)
    comm_halo_bytes: int = 0
    t_matvec_interior: float = 0.0      # split-matvec phase times (owned,
    t_matvec_halo: float = 0.0          # measured under tracing only)
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def parts(self) -> Optional[np.ndarray]:
        """Current element partition (propagated through refine/coarsen)."""
        return self.mesh.leaf_payload.get("parts")


def _ensure_elements(session: "AdaptiveSession", state: SessionState):
    """(Re)build P1 element arrays iff the cached ones are stale."""
    el = state.el
    if el is None or int(el.tets.shape[0]) != state.mesh.n_tets:
        state.el = build_elements(state.mesh.verts, state.mesh.tets,
                                  device=session.device)
    return state.el


def _verts(session: "AdaptiveSession", mesh: Mesh) -> torch.Tensor:
    return torch.as_tensor(mesh.verts.astype(np.float32), device=session.device)


def free_mask(mesh: Mesh, device) -> torch.Tensor:
    """1.0 on interior vertices, 0.0 on boundary ones (faces used by one
    leaf), float32 on ``device``.  The same set as
    ``Mesh.boundary_vertices``, found with a device-side unique."""
    t = torch.as_tensor(mesh.tets, device=device)
    faces = t[:, torch.as_tensor(TET_FACES, device=device)].reshape(-1, 3)
    faces = torch.sort(faces, dim=1).values
    uniq, counts = torch.unique(faces, dim=0, return_counts=True)
    free = torch.ones(mesh.n_verts, dtype=torch.float32, device=device)
    free[uniq[counts == 1].reshape(-1)] = 0.0
    return free


def _l2_error(el, verts: torch.Tensor, u: torch.Tensor, exact) -> float:
    """Vertex-rule L2 error of u against ``exact``."""
    t = el.tets.long()
    uq = u[t]                                           # (nt, 4)
    ue = exact(verts[t].reshape(-1, 3)).reshape(uq.shape)
    return float(torch.sqrt(((uq - ue) ** 2).mean(dim=1).mul(el.vol).sum()))


# ---------------------------------------------------------------------------
# Stage implementations
# ---------------------------------------------------------------------------

def _use_pallas(session: "AdaptiveSession") -> Optional[bool]:
    # the kernel knob of the nested BalanceSpec also selects the solve's
    # element-matvec kernel, as in the JAX package's owned-layout solve
    return session.balance_spec.use_pallas


def _replicated(session: "AdaptiveSession", x: torch.Tensor) -> torch.Tensor:
    """Rank 0's copy of a replicated quantity on every rank (sharded
    sessions).  The replicated mesh must not differ between ranks.  Every
    rank computes these values with the same operations on the same
    inputs, and the FEM's sums add in an order fixed by the mesh
    (``segment_sum``), so on one kind of card the copies agree bit for
    bit; the broadcast keeps that true where ranks run on cards or
    libraries that round differently (the NCCL route, one rank per card,
    has not run on more than one card)."""
    if session.comm is None:
        return x
    return session.comm.broadcast(x.contiguous())


@register_adapt_stage("solve", "stationary")
def _solve_stationary(session: "AdaptiveSession", state: SessionState):
    """One Dirichlet solve of ``-Delta u + c u = f`` on the current mesh."""
    prob = session.problem
    el = _ensure_elements(session, state)
    verts = _verts(session, state.mesh)
    rhs = load_vector(el, verts, prob.f)
    sol = solve_dirichlet(el, rhs, prob.exact(verts),
                          free_mask(state.mesh, session.device), prob.c,
                          tol=session.spec.tol, maxiter=session.spec.maxiter,
                          use_pallas=_use_pallas(session))
    state.u = _replicated(session, sol.x)
    state.cg_iters = int(sol.iters)


@register_adapt_stage("solve", "backward_euler")
def _solve_backward_euler(session: "AdaptiveSession", state: SessionState):
    """One backward-Euler step ``(M/dt + A) u = M u_prev/dt + f(t+dt)``."""
    prob = session.problem
    spec = session.spec
    t_next = state.t + spec.dt
    el = _ensure_elements(session, state)
    verts = _verts(session, state.mesh)
    fv = load_vector(el, verts, lambda x: prob.f(x, t_next))
    u_prev = torch.as_tensor(state.u, dtype=torch.float32,
                             device=session.device)
    rhs = mass_matvec(el, u_prev) / spec.dt + fv
    sol = solve_dirichlet(el, rhs, prob.exact(verts, t_next),
                          free_mask(state.mesh, session.device),
                          1.0 / spec.dt, tol=spec.tol, maxiter=spec.maxiter,
                          use_pallas=_use_pallas(session))
    state.u = _replicated(session, sol.x)
    state.cg_iters = int(sol.iters)


def _pack_owned(session: "AdaptiveSession", state: SessionState):
    """Owned-layout packing from the current mesh + partition: build the
    ``HaloPlan``, migrate and renumber this rank's element payloads,
    record the per-matvec communication model, and drop the cached
    operators.  Both the balance stage and the solve-path staleness
    repack go through here."""
    from .halo import build_halo_plan, publish_wire_model, update_halo_plan
    from .parallel import shard_elements_on_device
    el = _ensure_elements(session, state)
    mesh = state.mesh
    parts = np.asarray(mesh.leaf_payload["parts"])
    p = session.balance_spec.p
    if (session.spec.incremental and state.halo is not None
            and state.packed_tets is not None
            and state.packed_parts is not None):
        plan, hinfo = update_halo_plan(
            state.halo, state.packed_tets, state.packed_parts,
            mesh.tets, parts, mesh.n_verts, p)
    else:
        plan = build_halo_plan(mesh.tets, parts, mesh.n_verts, p)
        hinfo = {"mode": "scratch"}
    state.halo = plan
    state.halo_info = hinfo
    state.packed_tets = mesh.tets.copy()
    state.packed_parts = parts.copy()
    state.sharded = shard_elements_on_device(el, parts, p, session.comm,
                                             halo=plan)
    state.packed_ntets = mesh.n_tets
    state.packed_version = state.mesh_version
    state.owned_ops = {}
    state.cut = int(cut_links(torch.as_tensor(parts),
                              torch.as_tensor(mesh.face_adjacency())))
    # wire bytes in the solve's scalar width (float32)
    itemsize = el.vol.element_size()
    state.comm_psum_bytes = plan.psum_bytes(itemsize)
    state.comm_halo_bytes = plan.halo_bytes(itemsize)
    tr = telemetry.get_tracer()
    if tr.enabled:
        publish_wire_model(plan, tr.metrics, itemsize=itemsize)


def _ensure_owned_packing(session: "AdaptiveSession", state: SessionState):
    """(Re)build the owned-layout packing + halo plan iff stale.

    Fresh after the previous step's balance stage on the stationary
    loop; the time-dependent loop adapts the mesh before solving, so the
    inherited partition re-packs here.  The first step, with no
    partition at all, runs the balance policy once."""
    el = _ensure_elements(session, state)
    mesh = state.mesh
    if (state.halo is not None and state.sharded is not None
            and state.sharded.layout == "owned"
            and state.packed_version == state.mesh_version
            and state.halo.n_verts == el.n_verts
            and state.packed_ntets == mesh.n_tets):
        return
    parts = state.parts
    if parts is None or len(parts) != mesh.n_tets:
        _balance_common(session, state)
    _pack_owned(session, state)


def _owned_operators(session: "AdaptiveSession", state: SessionState,
                     c: float):
    """Cached (matvec, diagonal) pair for the current packing, rebuilt
    only when the packing is (``_pack_owned`` clears the cache)."""
    from .parallel import make_owned_operators
    ops = state.owned_ops.get(c)
    if ops is None:
        ops = make_owned_operators(state.sharded, session.comm, c,
                                   use_pallas=_use_pallas(session))
        state.owned_ops[c] = ops
    return ops


@register_adapt_stage("solve", "stationary_owned")
def _solve_stationary_owned(session: "AdaptiveSession", state: SessionState):
    """Stationary solve on owned vertices: distributed PCG whose matvec
    communicates by the halo exchange (no vertex-sized psum)."""
    from .parallel import sharded_solve_dirichlet
    prob = session.problem
    el = _ensure_elements(session, state)
    _ensure_owned_packing(session, state)
    verts = _verts(session, state.mesh)
    rhs = _replicated(session, load_vector(el, verts, prob.f))
    sol = sharded_solve_dirichlet(
        state.sharded, session.comm, rhs, prob.exact(verts),
        free_mask(state.mesh, session.device), prob.c,
        tol=session.spec.tol, maxiter=session.spec.maxiter,
        operators=_owned_operators(session, state, prob.c))
    state.u = sol.x
    state.cg_iters = int(sol.iters)


@register_adapt_stage("solve", "backward_euler_owned")
def _solve_backward_euler_owned(session: "AdaptiveSession",
                                state: SessionState):
    """Backward-Euler step on owned vertices (the system of the
    replicated variant, halo-exchange matvec)."""
    from .parallel import sharded_solve_dirichlet
    prob = session.problem
    spec = session.spec
    t_next = state.t + spec.dt
    el = _ensure_elements(session, state)
    _ensure_owned_packing(session, state)
    verts = _verts(session, state.mesh)
    fv = load_vector(el, verts, lambda x: prob.f(x, t_next))
    u_prev = torch.as_tensor(state.u, dtype=torch.float32,
                             device=session.device)
    rhs = _replicated(session, mass_matvec(el, u_prev) / spec.dt + fv)
    c = 1.0 / spec.dt
    sol = sharded_solve_dirichlet(
        state.sharded, session.comm, rhs, prob.exact(verts, t_next),
        free_mask(state.mesh, session.device), c, tol=spec.tol,
        maxiter=spec.maxiter, operators=_owned_operators(session, state, c))
    state.u = sol.x
    state.cg_iters = int(sol.iters)


@register_adapt_stage("estimate", "zz")
def _estimate_zz(session: "AdaptiveSession", state: SessionState):
    """Zienkiewicz--Zhu indicators for the current u (host copy)."""
    el = _ensure_elements(session, state)
    u = torch.as_tensor(state.u, dtype=torch.float32, device=session.device)
    state.eta = _replicated(session, zz_estimate(el, u)).cpu().numpy()


@register_adapt_stage("mark", "doerfler")
def _mark_doerfler(session: "AdaptiveSession", state: SessionState):
    state.marked = doerfler_mark(state.eta, session.spec.theta)


@register_adapt_stage("adapt_mesh", "refine")
def _adapt_refine(session: "AdaptiveSession", state: SessionState):
    """Stationary loop: refine the marked set; the final step and the
    ``max_tets`` ceiling skip refinement."""
    spec = session.spec
    state.grew = False
    last = spec.stationary and state.step >= spec.max_steps - 1
    if state.mesh.n_tets < spec.max_tets and not last:
        refine(state.mesh, state.marked)
        state.grew = True
        state.mesh_version += 1


@register_adapt_stage("adapt_mesh", "coarsen_refine")
def _adapt_coarsen_refine(session: "AdaptiveSession", state: SessionState):
    """Time-dependent loop: coarsen, re-estimate, mark and refine before
    stepping; records the pre-refine vertex mask for the transfer."""
    spec, mesh = session.spec, state.mesh
    estimate = session.stage_fn("estimate")
    state.el = None
    estimate(session, state)
    coarsen(mesh, threshold_coarsen_mark(state.eta, spec.coarsen_frac))
    state.mesh_version += 1
    state.el = None
    estimate(session, state)
    session.stage_fn("mark")(session, state)
    state.active_before = np.zeros(mesh.n_verts, bool)
    state.active_before[np.unique(mesh.tets)] = True
    state.grew = False
    if mesh.n_tets < spec.max_tets:
        refine(mesh, state.marked)
        state.grew = True
        state.mesh_version += 1


@register_adapt_stage("transfer", "p1")
def _transfer_stage_p1(session: "AdaptiveSession", state: SessionState):
    u = state.u.cpu().numpy() if isinstance(state.u, torch.Tensor) else state.u
    state.u = transfer_p1(np.asarray(u), state.active_before, state.mesh)


def _incremental_keys(session: "AdaptiveSession",
                      state: SessionState) -> np.ndarray:
    """SFC keys for the current mesh at per-step-delta cost.

    Keys live on the leaf payload (``sfc_key``) so refine/coarsen carry
    them; a copy of each leaf's connectivity row at key time (``sfc_tet``)
    is the dirty signature.  Only dirty leaves re-key, against the
    session's frozen bounding box, until the box drifts past the cache's
    tolerance."""
    mesh = state.mesh
    bspec = session.balance_spec
    coords = np.asarray(mesh.barycenters())
    pay = mesh.leaf_payload
    n = mesh.n_tets
    cache = session._key_cache
    dirty = None
    keys = pay.get("sfc_key")
    sig = pay.get("sfc_tet")
    if (cache is not None and keys is not None and len(keys) == n
            and sig is not None and len(sig) == n):
        cache = dataclasses.replace(cache, keys=np.asarray(keys, np.int64))
        dirty = (np.asarray(sig) != mesh.tets).any(axis=1)
    else:
        cache = None
    cache, info = refresh_key_cache(
        cache, coords, dirty,
        curve="morton" if bspec.method == "msfc" else "hilbert",
        uniform=bspec.method != "hsfc_zoltan", bits=bspec.sfc_bits,
        device=session.device, use_pallas=bspec.use_pallas)
    session._key_cache = cache
    pay["sfc_key"] = cache.keys
    pay["sfc_tet"] = mesh.tets.copy()
    state.key_info = info
    return cache.keys


def _balance_common(session: "AdaptiveSession", state: SessionState):
    """Trigger policy + one DLB step; parts persist in ``leaf_payload``
    so refine/coarsen propagate them to the next step."""
    spec, mesh = session.spec, state.mesh
    dev = session.device
    p = session.balance_spec.p
    w = torch.ones(mesh.n_tets, dtype=torch.float32, device=dev)
    inherited = mesh.leaf_payload.get("parts")
    if inherited is not None and len(inherited) != mesh.n_tets:
        inherited = None                 # stale payload on a foreign mesh
    cur = float("inf")
    if inherited is not None and spec.trigger != "always":
        cur = float(imbalance(torch.as_tensor(inherited, device=dev), w, p))
    if spec.trigger == "always":
        repart = True
    elif spec.trigger == "never":
        repart = inherited is None
    else:                                # 'imbalance' (the paper's)
        repart = inherited is None or cur > spec.imbalance_trigger
    first_this_step = state.balanced_step != state.step
    state.balanced_step = state.step
    if repart:
        keys = None
        if spec.incremental and session.balance_spec.method in SFC_METHODS:
            keys = _incremental_keys(session, state)
        coords = mesh.barycenters().astype(np.float32)
        br = session.balancer.balance(w, coords=coords, old_parts=inherited,
                                      keys=keys)
        parts = br.parts.cpu().numpy()
        state.balance_result = br
        state.step_imbalance = float(br.imbalance)
        state.migration_totalv = float(br.total_v)
        state.migration_retained = float(br.retained)
        state.repartitioned = True
    else:
        parts = np.asarray(inherited)
        state.step_imbalance = cur
        if first_this_step:
            state.balance_result = None
            state.migration_totalv = 0.0
            state.migration_retained = 0.0
            state.repartitioned = False
    mesh.leaf_payload["parts"] = parts


@register_adapt_stage("balance", "host")
def _balance_host(session: "AdaptiveSession", state: SessionState):
    _balance_common(session, state)


@register_adapt_stage("balance", "sharded")
def _balance_sharded(session: "AdaptiveSession", state: SessionState):
    """Sharded balance: the DLB pipeline over the process group (the
    sharded ``Balancer``), then the mesh's element payloads re-packed
    across the ranks with the migration executor's ``all_to_all`` -- the
    paper's per-step data migration.  With ``vertex_layout='owned'`` the
    ``HaloPlan`` is rebuilt from the fresh partition after every
    repartition (``_pack_owned``)."""
    from .parallel import shard_elements_on_device
    _balance_common(session, state)
    if session.spec.vertex_layout == "owned":
        # the solve stage may have packed this very (mesh, partition)
        # already; only a new partition or a mesh mutation needs a repack
        if (state.repartitioned or state.packed_version != state.mesh_version
                or state.sharded is None or state.sharded.layout != "owned"):
            _pack_owned(session, state)
        return
    el = _ensure_elements(session, state)
    mesh = state.mesh
    state.halo = None
    state.sharded = shard_elements_on_device(
        el, mesh.leaf_payload["parts"], session.balance_spec.p, session.comm)
    state.packed_ntets = mesh.n_tets
    state.packed_version = state.mesh_version


# ---------------------------------------------------------------------------
# AdaptiveSession
# ---------------------------------------------------------------------------

class AdaptiveSession:
    """Resolve an ``AdaptSpec`` into an adaptive loop on ``device``.

    ``device=None`` means CUDA (for the sharded backend: ``comm``'s
    device); without a CUDA device it raises unless ``device="cpu"`` is
    passed.  ``backend='sharded'`` needs ``comm``, a ``distributed.Comm``
    over exactly ``p`` ranks, each of which runs the session on the same
    mesh; it fails fast here on a missing group, a world size other than
    ``p`` or an unknown stage variant.  Hooks: ``on_step(stats, state)``
    after each step, ``on_stage(stage, variant, dt)`` after each
    top-level stage, and ``on_state(stage, state)`` after it with the
    live ``SessionState`` (an observer: it copies what it keeps and
    changes nothing).  ``run(mesh)`` uses the given mesh, else the
    session's, else the problem's default mesh."""

    def __init__(self, spec: AdaptSpec, *, mesh: Optional[Mesh] = None,
                 device=None, comm=None, verbose: bool = False,
                 on_step: Optional[Callable] = None,
                 on_stage: Optional[Callable] = None,
                 on_state: Optional[Callable] = None,
                 tracer: Optional["telemetry.Tracer"] = None):
        self.spec = spec
        self.comm = comm if spec.backend == "sharded" else None
        if device is None and self.comm is not None:
            device = self.comm.device
        self.device = resolve_device(device)
        self.setup = get_problem(spec.problem)
        if self.setup.kind == "parabolic" and spec.stationary:
            raise ValueError(f"problem {spec.problem!r} is time-dependent; "
                             "set dt > 0 and n_steps on the AdaptSpec")
        if self.setup.kind == "stationary" and not spec.stationary:
            raise ValueError(f"problem {spec.problem!r} is stationary; "
                             "dt must be 0 (use max_steps)")
        self.problem = self.setup.make()
        bspec = spec.balance
        if bspec.backend != spec.backend:
            bspec = bspec.replace(backend=spec.backend)
        if spec.incremental and not bspec.warm_start:
            bspec = bspec.replace(warm_start=True)
        self.balance_spec = bspec
        self._key_cache = None          # incremental SFC KeyCache
        # fails fast: the sharded backend checks the group against p
        self.balancer = Balancer(bspec, device=self.device, comm=self.comm)
        self.variants = resolve_adapt_variants(spec, self.setup)
        self._stages = {s: get_adapt_stage(s, v)
                        for s, v in self.variants.items() if v is not None}
        self.verbose = verbose
        self.on_step, self.on_stage = on_step, on_stage
        self.on_state = on_state
        self.tracer = tracer
        self._mesh = mesh

    def stage_fn(self, stage: str) -> Callable:
        """The resolved stage function (for nesting inside other stages)."""
        return self._stages[stage]

    def _run_stage(self, stage: str, state: SessionState,
                   bucket: Optional[str] = None) -> None:
        """Run one stage under an always-on stopwatch that waits for the
        stage's device outputs before the clock stops."""
        fn = self._stages[stage]
        with telemetry.stopwatch(f"adapt/{stage}",
                                 variant=self.variants[stage],
                                 step=state.step) as sw:
            fn(self, state)
            sw.block_on([x for x in (state.u, state.balance_result)
                         if x is not None])
        dt = sw.dur_s
        key = bucket or stage
        state.timings[key] = state.timings.get(key, 0.0) + dt
        if self.on_stage is not None:
            self.on_stage(stage, self.variants[stage], dt)
        if self.on_state is not None:
            self.on_state(stage, state)

    def _step_stationary(self, state: SessionState) -> None:
        _ensure_elements(self, state)
        self._run_stage("solve", state)
        self._run_stage("estimate", state)
        state.err_l2 = _l2_error(state.el, _verts(self, state.mesh), state.u,
                                 self.problem.exact)
        # mark + refine share the t_refine bucket (as the paper reports)
        self._run_stage("mark", state, bucket="adapt_mesh")
        self._run_stage("adapt_mesh", state)
        self._run_stage("balance", state)

    def _step_timedep(self, state: SessionState) -> None:
        t_next = state.t + self.spec.dt
        self._run_stage("adapt_mesh", state)
        self._run_stage("transfer", state)
        _ensure_elements(self, state)
        self._run_stage("solve", state)
        state.err_l2 = _l2_error(state.el, _verts(self, state.mesh), state.u,
                                 lambda x: self.problem.exact(x, t_next))
        self._run_stage("balance", state)
        state.t = t_next

    def run(self, mesh: Optional[Mesh] = None) -> AdaptiveResult:
        spec = self.spec
        mesh = mesh if mesh is not None else self._mesh
        if mesh is None:
            mesh = self.setup.default_mesh()
        state = SessionState(mesh=mesh)
        result = AdaptiveResult(spec=spec)
        stationary = self.setup.kind == "stationary"
        if not stationary:
            state.u = self.problem.exact(_verts(self, mesh), 0.0)
        n_iters = spec.max_steps if stationary else spec.n_steps
        scope = (telemetry.tracing(self.tracer) if self.tracer is not None
                 else contextlib.nullcontext())
        with scope:
            self._run_steps(state, result, stationary, n_iters)
        if state.u is not None:
            result.u = torch.as_tensor(state.u, device=self.device)
        result.mesh = state.mesh
        result.sharded = state.sharded
        result.halo = state.halo
        return result

    def _run_steps(self, state: SessionState, result: AdaptiveResult,
                   stationary: bool, n_iters: int) -> None:
        tr = telemetry.get_tracer()
        for step in range(n_iters):
            state.step = step
            state.timings = {}
            with tr.span("adapt/step", step=step) as sp:
                if stationary:
                    self._step_stationary(state)
                else:
                    self._step_timedep(state)
                sp.set(n_tets=state.mesh.n_tets)
            stats = self._emit_stats(state)
            result.stats.append(stats)
            tr.tick(step)
            if state.repartitioned:
                result.n_repartitions += 1
            if self.on_step is not None:
                self.on_step(stats, state)
            if self.verbose:
                head = (f"[{step}]" if stationary else f"[t={state.t:.3f}]")
                print(f"{head} nt={stats.n_tets:7d} err={stats.err_l2:.3e} "
                      f"eta={stats.eta:.3e} cg={stats.cg_iters} "
                      f"imb={stats.imbalance:.3f} "
                      f"solve={stats.t_solve:.2f}s "
                      f"bal={stats.t_balance:.3f}s")
            if stationary and not state.grew:
                break

    def _emit_stats(self, state: SessionState) -> StepStats:
        tr = telemetry.get_tracer()
        if tr.enabled:
            parts = state.mesh.leaf_payload.get("parts")
            if (state.halo is None and parts is not None
                    and len(parts) == state.mesh.n_tets):
                # the owned packing computes the cut of its partition;
                # under tracing every other backend pays for it here
                state.cut = int(cut_links(
                    torch.as_tensor(parts),
                    torch.as_tensor(state.mesh.face_adjacency())))
            if state.cut is not None:
                tr.metrics.gauge(
                    "cut", unit="links",
                    help="element-adjacency links crossing parts "
                         "(paper surface index)").set(int(state.cut))
            if (state.halo is not None and state.sharded is not None
                    and state.sharded.layout == "owned"
                    and state.sharded.n_interface is not None):
                # out-of-band split-matvec phase times, after the step's
                # stage clocks so t_solve is not inflated
                from .parallel import measure_matvec_phases
                c = (getattr(self.problem, "c", 0.0) if self.spec.stationary
                     else 1.0 / self.spec.dt)
                state.t_matvec_halo, state.t_matvec_interior = (
                    measure_matvec_phases(state.sharded, self.comm, c,
                                          use_pallas=_use_pallas(self),
                                          step=state.step))
        eta2 = np.asarray(state.eta, np.float64) ** 2
        tm = state.timings
        return StepStats(
            n_tets=state.mesh.n_tets, n_verts=state.mesh.n_verts,
            eta=float(np.sqrt(eta2.sum())), err_l2=state.err_l2,
            cg_iters=state.cg_iters,
            t_solve=tm.get("solve", 0.0),
            t_estimate=tm.get("estimate", 0.0),
            t_refine=tm.get("adapt_mesh", 0.0),
            t_balance=tm.get("balance", 0.0),
            imbalance=state.step_imbalance,
            repartitioned=state.repartitioned,
            migration_totalv=state.migration_totalv,
            cut=state.cut,
            migration_retained=state.migration_retained,
            t_transfer=tm.get("transfer", 0.0),
            comm_psum_bytes=state.comm_psum_bytes,
            comm_halo_bytes=state.comm_halo_bytes,
            t_matvec_interior=state.t_matvec_interior,
            t_matvec_halo=state.t_matvec_halo)


# ---------------------------------------------------------------------------
# Deprecated driver wrappers
# ---------------------------------------------------------------------------

# one shared key for both legacy drivers, as in the JAX package: the old
# machinery warned once per process across the pair, not once per driver
_DEPRECATION_KEY = "fem.adapt.legacy_drivers"


def _warn_deprecated_once(name: str) -> None:
    """Emit the legacy-driver DeprecationWarning once per process."""
    deprecation.warn_once(
        _DEPRECATION_KEY,
        f"{name} is deprecated; build an AdaptSpec and use "
        "repro_torch.fem.AdaptiveSession(spec).run(mesh) instead")


def _reset_deprecation_warning() -> None:
    """Testing hook: allow the once-per-process warning to fire again."""
    deprecation.reset(_DEPRECATION_KEY)


def solve_helmholtz_adaptive(mesh: Mesh, *, p: int = 16,
                             method: str = "hsfc",
                             theta: float = 0.5,
                             max_steps: int = 10,
                             max_tets: int = 200_000,
                             imbalance_trigger: float = 1.05,
                             tol: float = 1e-8,
                             backend: str = "host",
                             verbose: bool = False, device=None,
                             comm=None) -> AdaptiveResult:
    """DEPRECATED -- paper Example 3.1 via ``AdaptiveSession``.

    Equivalent to ``AdaptiveSession(AdaptSpec(problem='helmholtz', ...),
    device=device, comm=comm).run(mesh)``; the keywords map 1:1 onto the
    spec's fields."""
    _warn_deprecated_once("solve_helmholtz_adaptive")
    spec = AdaptSpec(problem="helmholtz", theta=theta, trigger="imbalance",
                     imbalance_trigger=imbalance_trigger,
                     balance=BalanceSpec(p=p, method=method, backend=backend),
                     backend=backend, max_steps=max_steps, max_tets=max_tets,
                     tol=tol)
    return AdaptiveSession(spec, device=device, comm=comm,
                           verbose=verbose).run(mesh)


def solve_parabolic_adaptive(mesh: Mesh, *, p: int = 16,
                             method: str = "hsfc", dt: float = 0.01,
                             n_steps: int = 20, theta: float = 0.4,
                             max_tets: int = 120_000,
                             coarsen_frac: float = 0.15,
                             tol: float = 1e-8,
                             backend: str = "host",
                             verbose: bool = False, device=None,
                             comm=None) -> AdaptiveResult:
    """DEPRECATED -- paper Example 3.2 via ``AdaptiveSession``.

    The previous step's partition is threaded into every balance call, so
    the Oliker--Biswas remap and the migration metrics are live."""
    _warn_deprecated_once("solve_parabolic_adaptive")
    spec = AdaptSpec(problem="parabolic", theta=theta,
                     coarsen_frac=coarsen_frac, trigger="always",
                     balance=BalanceSpec(p=p, method=method, backend=backend),
                     backend=backend, dt=dt, n_steps=n_steps,
                     max_tets=max_tets, tol=tol)
    return AdaptiveSession(spec, device=device, comm=comm,
                           verbose=verbose).run(mesh)


# ---------------------------------------------------------------------------
# Solution transfer
# ---------------------------------------------------------------------------

def peak_init(mesh: Mesh, prob: ParabolicProblem,
              device=None) -> torch.Tensor:
    """The parabolic problem's solution at t = 0 on the mesh's vertices
    (float32, on ``device``: default CUDA)."""
    verts = torch.as_tensor(mesh.verts.astype(np.float32),
                            device=resolve_device(device))
    return prob.exact(verts, 0.0)


def transfer_p1(u_old: np.ndarray, active_before: np.ndarray,
                mesh: Mesh) -> np.ndarray:
    """Transfer nodal values to the adapted mesh (host arrays).

    Values on vertices active before refinement are kept; every other
    vertex now in use is a bisection midpoint whose value is the mean of
    its edge endpoints.  A midpoint always has a larger vertex id than its
    endpoints, so one forward pass in id order resolves chains."""
    old_nv = active_before.shape[0]
    u_new = np.zeros(mesh.n_verts, np.float64)
    u_new[:old_nv] = np.asarray(u_old)[:old_nv]
    needs = np.ones(mesh.n_verts, bool)
    needs[:old_nv] = ~active_before
    if needs.any():
        pairs = np.array([[k >> 32, k & 0xFFFFFFFF, v]
                          for k, v in mesh.edge_mid.items()
                          if needs[v]], np.int64)
        if pairs.size:
            order = np.argsort(pairs[:, 2])
            for a, b, v in pairs[order]:
                u_new[v] = 0.5 * (u_new[a] + u_new[b])
    return u_new
