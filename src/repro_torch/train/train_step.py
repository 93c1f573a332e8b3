"""Train-step factory: loss -> grads -> (optionally compressed) -> AdamW.
Counterpart of ``repro/train/train_step.py``.

Data parallelism follows the reference's semantics: one packed global
batch, of which each rank of the data group takes its contiguous rows
(``P("data", None)``); each rank's loss term (``loss_fn(..., data=)``)
gives gradients that sum to the global batch's; the step sums them over
the group (as GSPMD sums them), applies the error feedback to the sum
when ``compress`` (the same on every rank), and updates with the moments
sharded ZeRO-style (``optimizer.zero_shards``).

On a model axis (``model``, the model group's ``Comm``) the model holds
this rank's slices (``slices``): the loss is the same on every rank of
the group (``loss_fn(..., model=)``), each gradient is of this rank's
slice (``sum_grads`` still sums over the data group only), and the clip
norm and the compression's scales of the sliced leaves are taken over
the model group."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models import ModelConfig, loss_fn
from .compress import CompressState, ef_compress_grads
from .optimizer import (F32, AdamWConfig, OptState, Shard, _chunks,
                        adamw_update, device_clock)

__all__ = ["count_diff", "device_clock", "gather_bytes", "make_train_step",
           "sum_grads"]


def count_diff(after: Dict, before: Dict) -> Dict:
    """Each counter's growth from ``before`` to ``after``."""
    return {k: v - before[k] for k, v in after.items()}


def sum_grads(grads: Dict[str, torch.Tensor], data) -> int:
    """Sum each gradient over the data group in float32 and round once to
    its dtype, in place, a slice of at most ``UPDATE_CHUNK`` elements at
    a time (a llama3-8b gradient in float32 is ~9 GB a rank); returns the
    bytes this rank handed to the all-reduces."""
    sent = 0
    for g in grads.values():
        for gc in _chunks(g):
            gc.copy_(data.psum(gc.to(F32)))
            sent += gc.numel() * 4
    return sent


def gather_bytes(params: Dict[str, torch.Tensor], shards, rank: int) -> int:
    """The bytes of the parameters' parts this rank hands to the update's
    all-gathers and broadcasts."""
    total = 0
    for n, p in params.items():
        sh = shards[n]
        if sh.dim is not None:
            total += p.numel() // p.shape[sh.dim] * sh.size * p.element_size()
        elif sh.owner == rank:
            total += p.numel() * p.element_size()
    return total


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    compress: bool = False, data=None,
                    shards: Optional[Dict[str, Shard]] = None, model=None,
                    slices: Optional[Dict] = None) -> Callable:
    """Returns ``train_step(lm, opt_state, batch[, comp_state],
    times=None)``: the loss of ``batch`` under ``loss_fn``, its gradients
    with respect to every parameter (``torch.autograd.grad``; the step
    turns on grad for the model it trains), with ``compress`` the
    error-feedback int8 round trip (scales shared as the reference's
    stacked layers share them), then one ``adamw_update``, which
    writes the model's parameters in place.  Returns ``(lm,
    opt_state[, comp_state], metrics)`` with ``metrics`` = ``{"loss",
    "gnorm", "lr"}`` (float32 scalars), as the reference does.

    With ``data`` (the data group's ``Comm``) and ``shards`` (this rank's
    ``zero_shards``, which the launcher builds from its rules), ``batch``
    is this rank's rows of the global batch, ``opt_state`` holds this
    rank's parts of the moments (``init_opt_state(lm, ocfg, shards,
    data.rank)``), the gradients are summed over the group before the
    compression and the update (``sum_grads``), and ``loss`` is the
    global batch's (the ranks' terms summed); metrics add the bytes this
    rank handed to the gradient all-reduces (``"reduce_bytes"``) and to
    the parameters' all-gathers and broadcasts (``"gather_bytes"``).

    With ``model`` (the model group's ``Comm``) and ``slices`` (this
    rank's ``distributed.sharding.model_slices``, from which the model
    was built), the step runs the model-parallel forward and backward;
    metrics add the bytes this rank handed to the model group's
    all-reduces and reduce-scatters in the step (``"model_bytes"``, the
    figure PRs before the by-kind count reported) and the model group's
    bytes by kind (``"model_bytes_by_kind"``: ``Comm.bytes_by_kind``'s
    result-shape accounting, which also counts the head_dim layout's
    forward all-gathers of q and k and their backward reduce-scatters)
    with the host seconds of each kind (``"model_s_by_kind"``).

    A dict passed as ``times`` receives the seconds of the forward +
    backward (``"grad"``), the gradient all-reduce (``"reduce"``, 0
    without ``data``), the compression and update (``"update"``) and,
    with ``data``, the parameters' all-gather within it (``"gather"``),
    each measured with the device synchronized, and with ``model`` the
    host seconds of the model group's all-reduces within the step
    (``"model"``, most of them within ``"grad"``).  ``grads_out``, a dict,
    receives the gradients the update consumed (summed, before any
    compression), by name."""
    if (data is None) != (shards is None):
        raise ValueError("data and shards come together: a data group's "
                         "step updates this rank's shards of the moments")
    if (model is None) != (slices is None):
        raise ValueError("model and slices come together: a model group's "
                         "step trains this rank's slices")
    split = frozenset(n for n, sl in (slices or {}).items() if sl is not None)

    def train_step(lm: torch.nn.Module, opt_state: OptState, batch: Dict,
                   comp_state: Optional[CompressState] = None, *,
                   times: Optional[Dict[str, float]] = None,
                   grads_out: Optional[Dict[str, torch.Tensor]] = None):
        lm.requires_grad_(True)
        params = dict(lm.named_parameters())
        dev = next(iter(params.values())).device
        if model is not None:
            sent0, spent0 = model.reduce_bytes, model.reduce_s
            kinds0 = dict(model.bytes_by_kind), dict(model.seconds_by_kind)
        t0 = device_clock(dev) if times is not None else 0.0
        with torch.enable_grad():
            loss = loss_fn(lm, batch, cfg, data=data, model=model)
            grads = torch.autograd.grad(loss, list(params.values()))
        grads = {n: g.contiguous() for n, g in zip(params, grads)}
        loss = loss.detach()
        if times is not None:
            t1 = device_clock(dev)
            times["grad"] = t1 - t0
        wire = 0
        if data is not None:
            wire = sum_grads(grads, data)
            loss = data.psum(loss)
        if times is not None:
            t2 = device_clock(dev)
            times["reduce"] = t2 - t1
        if grads_out is not None:
            grads_out.update(grads)
        if compress:
            grads, comp_state = ef_compress_grads(grads, comp_state, cfg,
                                                  model, split)
        opt_state, info = adamw_update(params, grads, opt_state, opt_cfg,
                                       shards=shards, data=data, times=times,
                                       model=model, split=split)
        del grads
        if times is not None:
            times["update"] = device_clock(dev) - t2
        metrics = {"loss": loss, **info}
        if data is not None:
            metrics["reduce_bytes"] = wire
            metrics["gather_bytes"] = gather_bytes(params, shards, data.rank)
        if model is not None:
            metrics["model_bytes"] = model.reduce_bytes - sent0
            metrics["model_bytes_by_kind"] = count_diff(model.bytes_by_kind,
                                                        kinds0[0])
            metrics["model_s_by_kind"] = count_diff(model.seconds_by_kind,
                                                    kinds0[1])
            if times is not None:
                times["model"] = model.reduce_s - spent0
        if compress:
            return lm, opt_state, comp_state, metrics
        return lm, opt_state, metrics

    return train_step
