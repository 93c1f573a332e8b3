"""DEPRECATED shim: ``DistributedBalancer`` over the ``BalanceSpec`` API.
Counterpart of ``repro/distributed/balancer.py``.

The multi-device pipeline lives in the stage registry
(``distributed.stages``), composed by ``core.Balancer`` with
``BalanceSpec(backend='sharded')``: SFC keys (group min / max box), the
1-D partition ('sorted' scan or the paper's 'ksection' histogram
search), the summed Oliker--Biswas remap and the all_to_all migration
executor, one rank per part.  This class keeps the old surface working
(host-facing ``balance`` with the float-metrics ``info`` dict).  New code
should use::

    spec = BalanceSpec(p=p, method='hsfc', backend='sharded')
    Balancer.from_spec(spec, comm=comm).balance(w, coords=xyz,
                                                 old_parts=old)

Where the JAX package takes ``devices`` and exposes its jax ``mesh``,
this one takes and exposes ``comm``, a ``distributed.Comm`` of ``p``
ranks; every rank constructs the balancer and calls ``balance`` with the
same global inputs.  The JAX package's ``_compiled`` (the capacity
buckets its jit traced) has no counterpart: the port traces nothing.
"""
from __future__ import annotations

from typing import Optional

from ..core.balancer import (LegacyBalanceResult, _warn_deprecated_once,
                             legacy_info)
from ..core.spec import Balancer, BalanceSpec, SFC_METHODS
from ..telemetry import stopwatch


class DistributedBalancer:
    """Sharded DLB over the ``p`` ranks of ``comm`` (legacy wrapper).

    method in {'hsfc', 'msfc', 'hsfc_zoltan'} (the SFC family; RTK and
    RCB stay host-driven).  ``device`` defaults to ``comm.device``."""

    def __init__(self, p: int, method: str = "hsfc", *, comm=None,
                 sfc_bits: int = 10, use_remap: bool = True,
                 use_pallas: Optional[bool] = None, min_capacity: int = 64,
                 execute_migration: bool = True, oneD: str = "sorted",
                 device=None):
        _warn_deprecated_once()
        if method not in SFC_METHODS:
            raise ValueError(
                f"DistributedBalancer supports SFC methods only, got "
                f"{method!r}")
        self.spec = BalanceSpec(
            p=p, method=method, oneD=oneD, sfc_bits=sfc_bits,
            use_remap=use_remap, backend="sharded",
            min_capacity=min_capacity, execute_migration=execute_migration,
            use_pallas=use_pallas)
        self._inner = Balancer.from_spec(self.spec, device=device, comm=comm)
        self.p, self.method = p, method
        self.sfc_bits, self.use_remap = sfc_bits, use_remap
        self.min_capacity = min_capacity
        self.execute_migration = execute_migration
        self.comm = comm
        self.device = self._inner.device

    def balance(self, weights, *, coords=None, old_parts=None,
                adjacency=None) -> LegacyBalanceResult:
        """Drop-in for ``DynamicLoadBalancer.balance`` (SFC methods).

        ``adjacency`` is accepted for signature compatibility; the cut
        metric needs the host-side element graph and is not computed on
        the sharded path."""
        if coords is None:
            raise ValueError("sharded balance requires coords (SFC methods)")
        with stopwatch("legacy/balance", backend="sharded") as sw:
            res = self._inner.balance(weights, coords=coords,
                                      old_parts=old_parts)
            sw.block_on(res.parts)
        info = legacy_info(self.spec, res, has_old=old_parts is not None,
                           t_balance=sw.dur_s)
        info["capacity"] = self._inner.capacity_for(int(weights.shape[0]))
        return LegacyBalanceResult(res.parts, info)
