"""No feature: the levels do not follow position (one bin)."""
import torch


def feature(x: torch.Tensor, t: float, params: dict) -> torch.Tensor:
    return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
