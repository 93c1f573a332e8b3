"""The DLB step as a PHG solver drives it: each ``step`` is one
``Balancer.balance`` call on the cell's coordinates and the next weight
field of its ring, with the previous repartition's parts as its old
parts (none where every repartition is a run's first)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from bench import check, profiling
from bench.generator import Inputs


class Kept:
    """Copies of one repartition's inputs and answers, in buffers made
    before the window: keeping the program's own tensors alive would
    change what its allocator hands out during the window."""

    def __init__(self, n: int, p: int, chained: bool, dev):
        self.parts = torch.empty(n, dtype=torch.int64, device=dev)
        self.old = (torch.empty(n, dtype=torch.int64, device=dev)
                    if chained else None)
        self.part_weights = torch.empty(p, dtype=torch.float32, device=dev)
        self.remap_perm = torch.empty(p, dtype=torch.int64, device=dev)
        self.splitters = torch.empty(p - 1, dtype=torch.float32, device=dev)
        self.scalars = torch.empty(4, dtype=torch.float32, device=dev)
        self.field = -1

    def take(self, item) -> None:
        field, old, res = item
        self.field = field
        self.parts.copy_(res.parts)
        if self.old is not None:
            self.old.copy_(old)
        self.part_weights.copy_(res.part_weights)
        self.remap_perm.copy_(res.remap_perm)
        self.splitters.copy_(res.splitters)
        for i, x in enumerate((res.imbalance, res.total_v, res.max_v,
                               res.retained)):
            self.scalars[i].copy_(x)

    @property
    def imbalance(self):
        return self.scalars[0]

    @property
    def total_v(self):
        return self.scalars[1]

    @property
    def max_v(self):
        return self.scalars[2]

    @property
    def retained(self):
        return self.scalars[3]


class Loop:
    """``balancer(spec, device)`` makes the object whose ``balance`` is
    timed: the program's ``Balancer`` unless given."""

    def __init__(self, config: dict, inputs: Inputs, device,
                 balancer: Optional[Callable] = None):
        from repro_torch.core import Balancer, BalanceSpec
        self.spec = BalanceSpec(**config["spec"])
        self.n = int(config["n"])
        self.inputs = inputs
        self.device = torch.device(device)
        self.make = balancer or (lambda spec, dev: Balancer(spec, dev))
        self.bal = None if inputs.fresh else self.make(self.spec, self.device)
        self.last = None
        self.i = 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        """(ring index, old parts, result) of one repartition."""
        i, w = self.i, self.inputs.weights(self.i)
        if self.inputs.fresh:
            bal, old = self.make(self.spec, self.device), None
        else:
            bal, old = self.bal, self.last
        res = bal.balance(w, coords=self.inputs.coords, old_parts=old)
        self.last = res.parts
        self.i += 1
        return self.inputs.field_index(i), old, res

    @staticmethod
    def counters(item) -> Dict[str, float]:
        r = item[2].ksection_rounds
        return {} if r is None else {"ksection_rounds": r}

    def buffer(self) -> Kept:
        return Kept(self.n, self.spec.p, not self.inputs.fresh, self.device)

    def span_stretch(self, reps: int):
        return profiling.span_stretch(self.step, reps, self.sync,
                                      self.spec.oneD)


def judge(config: dict, inputs: Inputs, kept: List[Kept]
          ) -> List[Dict[str, float]]:
    """The numbers compared, one dict for each kept repartition."""
    j = check.Judge(inputs.coords, int(config["spec"]["p"]))
    return [j.judge(inputs.fields[k.field], k.old, k) for k in kept]
