"""An axis-aligned box: ``lo`` and ``hi`` corners."""
import torch


def points(domain: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` points uniform in the box's volume, (n, 3) float32."""
    u = torch.rand((n, 3), generator=gen, device=device)
    lo = torch.tensor(domain["lo"], dtype=torch.float32, device=device)
    hi = torch.tensor(domain["hi"], dtype=torch.float32, device=device)
    return lo + u * (hi - lo)
