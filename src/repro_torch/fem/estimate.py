"""A-posteriori error estimation + Doerfler marking.

Zienkiewicz--Zhu gradient recovery (on the device): a nodal gradient
G(u_h) by volume-weighted averaging of the element gradients, then
eta_T^2 = || grad u_h - G(u_h) ||^2_{L2(T)} with the vertex rule.
Doerfler marking and coarsening marks stay on the host (numpy), copies of
``repro.fem.estimate``'s, so equal eta gives equal marks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..segment import segment_sum
from .assemble import P1Elements, element_gradients


def zz_estimate(el: P1Elements, u: torch.Tensor) -> torch.Tensor:
    """Per-element eta_T (not squared)."""
    gt = element_gradients(el, u)                       # (nt, 3)
    wv = el.vol[:, None]
    flat_ids = el.tets.reshape(-1)
    num = segment_sum(torch.repeat_interleave(gt * wv, 4, dim=0), flat_ids,
                      el.n_verts, el.order)
    den = segment_sum(torch.repeat_interleave(el.vol, 4), flat_ids,
                      el.n_verts, el.order)
    gnode = num / torch.clamp(den, min=1e-30)[:, None]  # (nv, 3)
    gv = gnode[el.tets.long()]                          # (nt, 4, 3)
    diff = gv - gt[:, None, :]
    eta2 = (diff * diff).sum(dim=(1, 2)) * el.vol / 4.0
    return torch.sqrt(eta2)


def doerfler_mark(eta: np.ndarray, theta: float = 0.5) -> np.ndarray:
    """Bool mask of marked elements (host side)."""
    eta2 = np.asarray(eta, np.float64) ** 2
    order = np.argsort(-eta2)
    csum = np.cumsum(eta2[order])
    total = csum[-1] if csum.size else 0.0
    k = int(np.searchsorted(csum, theta * total)) + 1
    marked = np.zeros(eta2.shape[0], bool)
    marked[order[:k]] = True
    return marked


def threshold_coarsen_mark(eta: np.ndarray, frac: float = 0.05) -> np.ndarray:
    """Mark elements with eta below ``frac`` * mean for coarsening."""
    eta = np.asarray(eta, np.float64)
    if eta.size == 0:
        return np.zeros(0, bool)
    return eta < frac * max(eta.mean(), 1e-300)
