"""Train-step factory: loss -> grads -> (optionally compressed) -> AdamW.
Counterpart of ``repro/train/train_step.py``."""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..models import ModelConfig, loss_fn
from .compress import CompressState, ef_compress_grads
from .optimizer import AdamWConfig, OptState, adamw_update


def device_clock(device: torch.device) -> float:
    """``time.perf_counter()`` once ``device``'s queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    compress: bool = False) -> Callable:
    """Returns ``train_step(model, opt_state, batch[, comp_state],
    times=None)``: the loss of ``batch`` under ``loss_fn``, its gradients
    with respect to every parameter (``torch.autograd.grad``; the step
    turns on grad for the model it trains), with ``compress`` the
    error-feedback int8 round trip (scales shared as the reference's
    stacked layers share them), then one ``adamw_update``, which
    writes the model's parameters in place.  Returns ``(model,
    opt_state[, comp_state], metrics)`` with ``metrics`` = ``{"loss",
    "gnorm", "lr"}`` (float32 scalars), as the reference does.  A dict
    passed as ``times`` receives the seconds of the forward + backward
    (``"grad"``) and of the compression and update (``"update"``),
    measured with the device synchronized."""

    def train_step(model: torch.nn.Module, opt_state: OptState, batch: Dict,
                   comp_state: Optional[CompressState] = None, *,
                   times: Optional[Dict[str, float]] = None):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        t0 = device_clock(dev) if times is not None else 0.0
        with torch.enable_grad():
            loss = loss_fn(model, batch, cfg)
            grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        if times is not None:
            t1 = device_clock(dev)
            times["grad"] = t1 - t0
        if compress:
            grads, comp_state = ef_compress_grads(grads, comp_state, cfg)
        opt_state, info = adamw_update(params, grads, opt_state, opt_cfg)
        del grads
        if times is not None:
            times["update"] = device_clock(dev) - t1
        metrics = {"loss": loss.detach(), **info}
        if compress:
            return model, opt_state, comp_state, metrics
        return model, opt_state, metrics

    return train_step
