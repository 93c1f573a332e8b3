"""AdamW.  Counterpart of ``repro/train/optimizer.py``.

The parameters, gradients and the moments ``m`` / ``v`` are dicts keyed
by the port model's parameter names (``named_parameters``).  Every
scalar the reference computes in float32 (the schedule, the bias
corrections, the clip scale) is a float32 tensor here too, and each
leaf's update runs in float32 and is cast back to the parameter's dtype,
as the reference's ``adamw_update`` does.  The update writes the
parameters and moments in place, a slice of at most ``UPDATE_CHUNK``
elements at a time, so that its float32 temporaries stay small beside
a 525M-element embedding (the result is the same: the update is
elementwise).

``adam_dtype='bfloat16'`` keeps m and v in bf16 (rounded after each
float32 update).  The reference's ``zero_pspec`` (optimizer state
sharded over the data axis) waits with multi-rank training (ROADMAP.md,
queue 1, item 14).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch

F32 = torch.float32
#: elements of one leaf updated at a time
UPDATE_CHUNK = 1 << 26

Params = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    adam_dtype: str = "float32"       # bf16 halves optimizer memory
    warmup: int = 100
    total_steps: int = 10000


class OptState(NamedTuple):
    step: int                          # updates taken
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def named(params: Params) -> Dict[str, torch.Tensor]:
    """A model's parameters by name, or the dict given."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params: Params, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``adam_dtype``, beside each parameter."""
    dt = getattr(torch, cfg.adam_dtype)
    zeros = {n: torch.zeros(p.shape, dtype=dt, device=p.device)
             for n, p in named(params).items()}
    return OptState(0, zeros, {n: torch.zeros_like(z)
                               for n, z in zeros.items()})


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then a cosine from ``lr`` down
    to ``0.1 lr`` at ``total_steps``; a float32 scalar."""
    s = torch.as_tensor(step).to(F32)
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup) / max(cfg.total_steps - cfg.warmup,
                                              1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32, summed
    leaf by leaf in the mapping's order (the reference sums in its tree's
    sorted-key order, so the two may differ in the last bits)."""
    total = None
    for x in tensors.values():
        sq = torch.sum(x.to(F32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _chunks(t: torch.Tensor):
    return t.view(-1).split(UPDATE_CHUNK)


@torch.no_grad()
def adamw_update(params: Params, grads: Mapping[str, torch.Tensor],
                 state: OptState, cfg: AdamWConfig
                 ) -> Tuple[OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: global-norm clipping to ``clip_norm``, bias
    correction, decoupled weight decay.  Writes the parameters and
    ``state``'s moments in place; returns the state with the step
    advanced and ``{"gnorm", "lr"}`` (float32 scalars; gnorm on the
    gradients' device, before clipping)."""
    params = named(params)
    step = state.step + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    s = torch.tensor(float(step), dtype=F32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - torch.tensor(b1, dtype=F32) ** s)
    bc2 = float(1 - torch.tensor(b2, dtype=F32) ** s)
    lr_f = float(lr)
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(grads[name]),
                                  _chunks(m), _chunks(v)):
            gf = gc.to(F32) * scale.to(gc.device)
            m_new = b1 * mc.to(F32) + (1 - b1) * gf
            v_new = b2 * vc.to(F32) + (1 - b2) * gf * gf
            del gf
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            mc.copy_(m_new)
            vc.copy_(v_new)
            del m_new, v_new
            pf = pc.to(F32)
            pc.copy_(pf - lr_f * (upd + cfg.weight_decay * pf))
    return OptState(step, state.m, state.v), {"gnorm": gnorm, "lr": lr}
