"""Plain PyTorch versions of the hand-written kernels.

The CPU path of every kernel and the yardstick ``chip_smoke.py`` holds
each kernel against on the card.  Counterpart of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

from ..core import partition1d as _p1d
from ..core import sfc as _sfc
from ..segment import segment_sum
from .fem_matvec import _MASS20


# --- sfc_keys --------------------------------------------------------------

def morton_keys_ref(grid: torch.Tensor, bits: int = 10) -> torch.Tensor:
    return _sfc.morton_encode(grid.to(torch.int64), bits)


def hilbert_keys_ref(grid: torch.Tensor, bits: int = 10) -> torch.Tensor:
    return _sfc.hilbert_encode(grid.to(torch.int64), bits)


# --- ksection_hist ---------------------------------------------------------

def ksection_histogram_ref(keys: torch.Tensor, weights: torch.Tensor,
                           cuts: torch.Tensor) -> torch.Tensor:
    """Weight strictly below each candidate cut (cuts in any order):
    ``core.partition1d.weight_below`` in float32."""
    return _p1d.weight_below(keys, weights.to(torch.float32),
                             cuts.to(torch.float32))


# --- fem_matvec ------------------------------------------------------------

def fem_matvec_kel_ref(tets: torch.Tensor, kel: torch.Tensor,
                       u: torch.Tensor, n_out: int) -> torch.Tensor:
    """The kernel's function on the kernel's inputs: gather the 4 vertex
    values (pad slot clamped to ``V - 1``), apply the precomputed 4x4
    ``K_e``, scatter-add into ``n_out`` slots (slot ``n_out`` dropped)."""
    t = tets.long()
    ue = u[t.clamp(max=u.shape[0] - 1)]
    au = torch.einsum("cij,cj->ci", kel.to(u.dtype), ue)
    return segment_sum(au.reshape(-1), t.reshape(-1), n_out)


def fem_matvec_ref(tets: torch.Tensor, grads: torch.Tensor, vol: torch.Tensor,
                   u: torch.Tensor, n_out: int, *, c: float = 0.0
                   ) -> torch.Tensor:
    """Geometry form of the element matvec (the JAX package's oracle):
    stiffness (+ ``c`` mass) einsums per call, masked scatter-add.
    ``tets``: (C, 4) slot ids in ``[0, n_out]``; ``u``: (V,), V >= n_out."""
    t = tets.long()
    mass = torch.as_tensor(_MASS20 / 20.0, dtype=grads.dtype,
                           device=grads.device)
    ue = u[t.clamp(max=u.shape[0] - 1)]
    flux = torch.einsum("cid,ci->cd", grads, ue)
    au = torch.einsum("cjd,cd->cj", grads, flux) * vol[:, None]
    if c != 0.0:
        au = au + c * torch.einsum("ij,cj->ci", mass, ue) * vol[:, None]
    return segment_sum(au.reshape(-1), t.reshape(-1), n_out)
