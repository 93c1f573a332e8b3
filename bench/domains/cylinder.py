"""A circular cylinder along x from the origin: ``length`` and ``radius``."""
import math

import torch


def points(domain: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` points uniform in the cylinder's volume, (n, 3) float32."""
    u = torch.rand((n, 3), generator=gen, device=device)
    r = domain["radius"] * torch.sqrt(u[:, 1])
    th = 2.0 * math.pi * u[:, 2]
    u[:, 0] *= domain["length"]
    u[:, 1] = r * torch.cos(th)
    u[:, 2] = r * torch.sin(th)
    return u
