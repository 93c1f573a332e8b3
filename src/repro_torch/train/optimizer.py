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
float32 update).

Data-parallel training shards the moments ZeRO-style, as the
reference's ``zero_pspec`` does: each leaf's moments are split over the
data ranks along the first dim whose rule is None and whose size the
data ranks divide.  The reference's leaves stack the layers of most
families on a leading ``"layers"`` dim; where that is the dim chosen,
rank r holds the moments of the port's whole per-layer tensors of
layers ``[r L/D, (r+1) L/D)`` (``zero_shards``).  ``adamw_update`` with
``shards`` and ``data`` updates each rank's part of every leaf (the
parameters, m and v) from the summed gradients, the same on every rank,
then all-gathers the parameters: the result is bit for bit that of one
rank's update, since the update is elementwise and the clip's global
norm is taken over the whole gradients on every rank.

On a model axis each rank holds its slices of the model-parallel leaves
(``distributed.sharding.model_slices``) and the moments of those
slices; ``zero_shards`` splits each rank's slice over the data ranks
along the dims the rules leave free, exactly as it splits a whole leaf
(the dims on "model" are never the ZeRO dim), and the clip's global norm
sums the squares of the sliced leaves over the model group and counts
each replicated leaf once (``adamw_update(..., model=, split=)``).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from ..distributed.sharding import leaf_shape, param_axes, stack_size, stacked

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


def device_clock(device: torch.device) -> float:
    """``time.perf_counter()`` once ``device``'s queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


# ---------------------------------------------------------------------------
# ZeRO sharding of the moments
# ---------------------------------------------------------------------------

def zero_pspec(cfg, params: Params, rules: dict,
               data_axes: Tuple[str, ...], data_size: int
               ) -> Dict[str, tuple]:
    """The partition spec of each parameter's moments by name: the spec
    of the reference leaf that holds it (``distributed.sharding``) with
    the data axis folded into the first dim whose rule is None and whose
    size ``data_size`` divides (the reference's ``zero_pspec``).
    ``params`` gives the names and shapes (a model, or a dict; tensors on
    the ``meta`` device do)."""
    tensors = named(params)
    axes = param_axes(cfg, list(tensors))
    data = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    out = {}
    for name, p in tensors.items():
        shape = leaf_shape(cfg, name, p.shape)
        base = [rules.get(a) if a is not None else None for a in axes[name]]
        for i, cur in enumerate(base):
            if cur is None and shape[i] % data_size == 0 and shape[i] > 0:
                base[i] = data
                break
        out[name] = tuple(base)
    return out


@dataclass(frozen=True)
class Shard:
    """This rank's part of one parameter's update: ``dim`` None and
    ``owner`` None -- the whole tensor, on every rank (replicated); ``dim``
    None and an ``owner`` -- the whole tensor, on that rank only (a layer
    of a stack sharded over its layers); else rows ``[start, start +
    size)`` of the tensor's dim ``dim``."""
    dim: Optional[int] = None
    start: int = 0
    size: int = 0
    owner: Optional[int] = None

    def mine(self, rank: int) -> bool:
        return self.owner is None or self.owner == rank


def zero_shards(cfg, params: Params, rules: dict, data_size: int,
                rank: int) -> Dict[str, Shard]:
    """Each parameter's ``Shard`` on data rank ``rank`` of ``data_size``,
    from ``zero_pspec``'s dims."""
    specs = zero_pspec(cfg, params, rules, ("data",), data_size)
    out = {}
    for name, p in named(params).items():
        dims = [i for i, a in enumerate(specs[name]) if a == "data"]
        st = stacked(cfg, name)
        if not dims or data_size == 1:
            out[name] = Shard()
        elif st and dims[0] == 0:
            per = stack_size(cfg, st[0]) // data_size
            out[name] = Shard(owner=st[1] // per)
        else:
            dim = dims[0] - (1 if st else 0)
            size = p.shape[dim] // data_size
            out[name] = Shard(dim=dim, start=rank * size, size=size)
    return out


def _local(t: torch.Tensor, sh: Shard) -> torch.Tensor:
    """The part of ``t`` a shard covers (a view)."""
    return t if sh.dim is None else t.narrow(sh.dim, sh.start, sh.size)


def init_opt_state(params: Params, cfg: AdamWConfig,
                   shards: Optional[Dict[str, Shard]] = None,
                   rank: int = 0) -> OptState:
    """Zero moments in ``adam_dtype``, beside each parameter; with
    ``shards`` (``zero_shards`` of data rank ``rank``), only this rank's
    part of each (none for a layer another rank owns)."""
    dt = getattr(torch, cfg.adam_dtype)
    zeros = {}
    for n, p in named(params).items():
        if shards is None:
            zeros[n] = torch.zeros(p.shape, dtype=dt, device=p.device)
        elif shards[n].mine(rank):
            zeros[n] = torch.zeros(_local(p, shards[n]).shape, dtype=dt,
                                   device=p.device)
    return OptState(0, zeros, {n: torch.zeros_like(z)
                               for n, z in zeros.items()})


def _gather(t_local: Optional[torch.Tensor], full: torch.Tensor, sh: Shard,
            data) -> torch.Tensor:
    """Every rank's part of a tensor, into ``full`` (in place; a whole
    tensor one rank owns is broadcast from it, a replicated one is left
    as it is)."""
    if sh.dim is None:
        if sh.owner is not None:        # the owner's ``full`` is its part
            full.copy_(data.broadcast(full, src=sh.owner))
        return full
    parts = data.all_gather(t_local.movedim(sh.dim, 0))
    full.copy_(parts.movedim(0, sh.dim))
    return full


@torch.no_grad()
def gather_moment(local: Optional[torch.Tensor], p: torch.Tensor,
                  sh: Shard, data, dtype: torch.dtype) -> torch.Tensor:
    """One whole moment of parameter ``p`` on every rank, from each
    rank's part ``local`` (None where this rank holds none): a
    collective, which every rank of ``data`` calls."""
    if sh.dim is None and sh.owner is None:
        return local.clone()
    full = (local.clone() if sh.owner == data.rank
            else torch.empty(p.shape, dtype=dtype, device=p.device))
    return _gather(local, full, sh, data)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then a cosine from ``lr`` down
    to ``0.1 lr`` at ``total_steps``; a float32 scalar."""
    s = torch.as_tensor(step).to(F32)
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup) / max(cfg.total_steps - cfg.warmup,
                                              1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _global_norm(tensors: Mapping[str, torch.Tensor], model=None,
                 split=frozenset()) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32, summed
    leaf by leaf in the mapping's order and within a leaf a slice of at
    most ``UPDATE_CHUNK`` elements at a time, so that the float32 squares
    of a 525M-element embedding stay small (the reference sums in its
    tree's sorted-key order, so the two may differ in the last bits).
    With the model group ``model``, the leaves named in ``split`` are
    this rank's slices: their sum is summed over the group (one
    all-reduce) and added to that of the replicated leaves, which every
    rank of the group holds alike and counts once."""
    total = part = torch.zeros((), dtype=F32,
                               device=next(iter(tensors.values())).device)
    for name, x in tensors.items():
        for xc in x.reshape(-1).split(UPDATE_CHUNK):
            sq = torch.sum(xc.to(F32) ** 2)
            if model is not None and name in split:
                part = part + sq
            else:
                total = total + sq
    if model is not None:
        total = total + model.psum(part)
    return torch.sqrt(total)


def _chunks(t: torch.Tensor):
    return t.view(-1).split(UPDATE_CHUNK)


@torch.no_grad()
def adamw_update(params: Params, grads: Mapping[str, torch.Tensor],
                 state: OptState, cfg: AdamWConfig,
                 shards: Optional[Dict[str, Shard]] = None, data=None,
                 times: Optional[Dict[str, float]] = None, model=None,
                 split=frozenset()
                 ) -> Tuple[OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: global-norm clipping to ``clip_norm``, bias
    correction, decoupled weight decay.  Writes the parameters and
    ``state``'s moments in place; returns the state with the step
    advanced and ``{"gnorm", "lr"}`` (float32 scalars; gnorm on the
    gradients' device, before clipping).

    With ``shards`` (``zero_shards`` of this rank of the data group
    ``data``), ``grads`` are the summed gradients (the same on every
    rank) and ``state`` holds this rank's parts of the moments: each rank
    updates its part of every parameter, then the parts are all-gathered
    (a layer owned by one rank is broadcast from it).  A dict passed as
    ``times`` receives the seconds of the gathering (``"gather"``, the
    device synchronized).  With the model group ``model``, the leaves
    named in ``split`` are this rank's slices (``_global_norm``)."""
    params = named(params)
    rank = 0 if data is None else data.rank
    step = state.step + 1
    gnorm = _global_norm(grads, model, split)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    s = torch.tensor(float(step), dtype=F32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - torch.tensor(b1, dtype=F32) ** s)
    bc2 = float(1 - torch.tensor(b2, dtype=F32) ** s)
    lr_f = float(lr)
    updated = {}
    for name, p in params.items():
        sh = shards[name] if shards is not None else Shard()
        if not sh.mine(rank):
            continue
        m, v = state.m[name], state.v[name]
        # a part along a dim past the first is strided: update a copy
        pl = _local(p, sh)
        pl = pl if pl.is_contiguous() else pl.contiguous()
        gl = _local(grads[name], sh).contiguous()
        for pc, gc, mc, vc in zip(_chunks(pl), _chunks(gl),
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
        updated[name] = pl
    if shards is not None and data is not None:
        t0 = device_clock(gnorm.device) if times is not None else 0.0
        for name, p in params.items():
            _gather(updated.get(name), p, shards[name], data)
        if times is not None:
            times["gather"] = device_clock(gnorm.device) - t0
    return OptState(step, state.m, state.v), {"gnorm": gnorm, "lr": lr}
