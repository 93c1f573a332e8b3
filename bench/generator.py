"""A cell's inputs, made on the device from the configuration and the
seed by the generator its traffic mix names
(``bench/generators/<name>.py``, ``make_inputs(config, traffic, seed,
device)``)."""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from bench import plugins


@dataclasses.dataclass
class Inputs:
    coords: torch.Tensor          # (n, 3) float32
    fields: List[torch.Tensor]    # the ring of (n,) float32 weights
    start: int                    # ring position of the first step
    fresh: bool                   # every repartition a run's first

    def weights(self, i: int) -> torch.Tensor:
        return self.fields[(self.start + i) % len(self.fields)]

    def field_index(self, i: int) -> int:
        return (self.start + i) % len(self.fields)


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    return plugins.load("generators", traffic["generator"]).make_inputs(
        config, traffic, seed, device)
