"""DEPRECATED shim: ``DynamicLoadBalancer`` over the ``BalanceSpec`` API.
Counterpart of ``repro/core/balancer.py``.

The eager balancer object of the old API, kept working over
``core.spec``: the same constructor keywords, the same
``BalanceResult(parts, info)`` with float metrics and a wall-clock time
in the ``info`` dict.  Migration guide::

    DynamicLoadBalancer(p, method, oneD=..., backend=...)
        -> Balancer.from_spec(BalanceSpec(p=p, method=method,
                                          oneD=..., backend=...))
    result.info["imbalance"]  -> float(result.imbalance)
    result.info["TotalV"]     -> float(result.total_v)
    timings                   -> Balancer.balance_timed(...)

Where the JAX package's shim balances on its default devices, this one
takes ``device=`` (default CUDA) and, for ``backend='sharded'``,
``comm=`` (a ``distributed.Comm`` of ``p`` ranks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .. import deprecation
from ..telemetry import stopwatch
from .spec import Balancer, BalanceSpec, compute_cut

_DEPRECATION_KEY = "DynamicLoadBalancer"


def _warn_deprecated_once() -> None:
    """Emit the legacy-API DeprecationWarning once per process."""
    deprecation.warn_once(
        _DEPRECATION_KEY,
        "DynamicLoadBalancer is deprecated; build a BalanceSpec and "
        "use repro_torch.core.Balancer.from_spec(spec) instead")


def _reset_deprecation_warning() -> None:
    """Testing hook: allow the once-per-process warning to fire again."""
    deprecation.reset(_DEPRECATION_KEY)


@dataclass
class LegacyBalanceResult:
    parts: torch.Tensor              # (n,) process id per item
    info: Dict                       # quality + migration metrics + timings


# import-path compatibility: `from repro_torch.core.balancer import
# BalanceResult`
BalanceResult = LegacyBalanceResult


def legacy_info(spec: BalanceSpec, res, *, adjacency=None,
                has_old: bool = False, t_balance: float = 0.0) -> Dict:
    """Convert a ``core.BalanceResult`` into the old ``info`` dict (the
    JAX package's keys and Python types)."""
    info: Dict = {
        "imbalance": float(res.imbalance),
        "part_weights": res.part_weights.cpu().numpy(),
        "cut": (None if adjacency is None
                else int(compute_cut(res.parts, adjacency))),
        "t_partition": t_balance,
        "t_remap": 0.0,
    }
    if spec.backend == "sharded":
        info["backend"] = "sharded"
    if has_old:
        info.update(TotalV=float(res.total_v), MaxV=float(res.max_v),
                    retained=float(res.retained))
        if spec.use_remap:
            info["remap_perm"] = res.remap_perm
        if res.migration is not None:
            info.update(
                mig_weight_in=float(res.migration["weight_in"]),
                mig_weight_out=float(res.migration["weight_out"]),
                mig_items=int(res.migration["items"]),
                mig_overflow=int(res.migration["overflow"]))
    return info


class DynamicLoadBalancer:
    """DEPRECATED -- thin shim over ``repro_torch.core.Balancer``.

    method in {'rtk', 'hsfc', 'msfc', 'hsfc_zoltan', 'rcb'}; backend in
    {'host', 'sharded'}; both 1-D solvers run on both backends.
    ``device`` (default CUDA) and ``comm`` go to the ``Balancer``."""

    def __init__(self, p: int, method: str = "hsfc", *,
                 oneD: str = "sorted", k: int = 8, iters: int = 12,
                 use_remap: bool = True, sfc_bits: int = 10,
                 backend: str = "host", device=None, comm=None):
        _warn_deprecated_once()
        self.spec = BalanceSpec(p=p, method=method, oneD=oneD, k=k,
                                iters=iters, use_remap=use_remap,
                                sfc_bits=sfc_bits, backend=backend)
        # attribute compatibility
        self.p, self.method, self.oneD = p, method, oneD
        self.k, self.iters = k, iters
        self.use_remap, self.sfc_bits = use_remap, sfc_bits
        self.backend = backend
        self.device, self.comm = device, comm
        self._balancer: Optional[Balancer] = None

    def _get(self) -> Balancer:
        # lazy, so that a spec / backend combination with no registered
        # stage (or a sharded spec without its group) raises at
        # balance() time, as the old API did
        if self._balancer is None:
            self._balancer = Balancer.from_spec(self.spec, device=self.device,
                                                comm=self.comm)
        return self._balancer

    def balance(self, weights, *, coords=None, old_parts=None,
                adjacency=None) -> LegacyBalanceResult:
        bal = self._get()
        with stopwatch("legacy/balance", backend=self.spec.backend) as sw:
            res = bal.balance(weights, coords=coords, old_parts=old_parts)
            sw.block_on(res.parts)
        info = legacy_info(self.spec, res, adjacency=adjacency,
                           has_old=old_parts is not None,
                           t_balance=sw.dur_s)
        if self.spec.backend == "sharded":
            info["capacity"] = bal.capacity_for(int(weights.shape[0]))
        return LegacyBalanceResult(res.parts, info)
