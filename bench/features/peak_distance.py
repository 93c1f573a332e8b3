"""Example 3.2's moving peak: the distance from its centre
c(t) = (1/2 + 2/5 sin 8 pi t, 1/2 + 2/5 cos 8 pi t, 1), taken ``lag``
earlier, since the mesh trails the peak."""
import math

import torch


def feature(x: torch.Tensor, t: float, params: dict) -> torch.Tensor:
    s = t - float(params.get("lag", 0.0))
    cx = 0.5 + 0.4 * math.sin(8.0 * math.pi * s)
    cy = 0.5 + 0.4 * math.cos(8.0 * math.pi * s)
    r2 = (x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2 + (x[:, 2] - 1.0) ** 2
    return torch.sqrt(r2)
