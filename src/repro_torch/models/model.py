"""Model registry: family -> init, loss and hidden states, for every
family of the JAX package."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..device import resolve_device
from . import transformer as T
from .config import ModelConfig
from .layers import building

#: the LM of each family ``init_model`` builds (the VLM is a decoder whose
#: stub front end hands it patch embeddings)
LMS = {"dense": T.DecoderLM, "moe": T.DecoderLM, "vlm": T.DecoderLM,
       "ssm": T.SSMLM, "hybrid": T.HybridLM, "encdec": T.EncDecLM}
FAMILIES = tuple(LMS)


def init_model(cfg: ModelConfig, seed: Optional[int] = 0, *, device=None,
               slices: Optional[Mapping] = None) -> torch.nn.Module:
    """A model of ``cfg`` on ``device`` (default CUDA) with random weights
    from a ``torch.Generator`` seeded with ``seed`` on that device (the
    same seed gives other numbers on another device); ``seed=None`` leaves
    the weights uninitialised, to be loaded.

    ``slices`` (a model rank's ``distributed.sharding.model_slices``, by
    parameter name) keeps only this rank's part of each parameter: every
    parameter is drawn whole, in the one-rank order, and cut before the
    next is drawn, so the parts equal the slices of the one-rank model
    of the same seed and the device holds one whole parameter at most
    beyond them."""
    dev = resolve_device(device)
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r}: one of {FAMILIES}")
    gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
    if slices is None:
        with torch.no_grad():
            return LMS[cfg.family](cfg, dev, gen)
    built = []

    def record(w):
        built.append(torch.nn.Parameter(w, requires_grad=False))
        return built[-1]
    with building(record):
        names = {id(p): n for n, p in
                 LMS[cfg.family](cfg, "meta", None).named_parameters()}
    parts = iter([slices[names[id(p)]] for p in built])

    def cut(w):
        sl = next(parts)
        return torch.nn.Parameter(w if sl is None else w.narrow(*sl).clone(),
                                  requires_grad=False)
    with torch.no_grad(), building(cut):
        return LMS[cfg.family](cfg, dev, gen)


def model_from_tensors(cfg: ModelConfig, tensors: Dict[str, torch.Tensor]
                       ) -> torch.nn.Module:
    """A model of ``cfg`` whose parameters are ``tensors`` themselves
    (``state_dict`` names), not copies: the ranks of a group that share
    one card wrap one set of weights this way (CUDA tensors handed to a
    process started by ``spawn`` arrive by CUDA IPC, without a copy).
    Nothing may write the weights of such a model."""
    model = init_model(cfg, seed=None, device="meta")
    model.load_state_dict(tensors, strict=True, assign=True)
    return model


def loss_fn(lm: torch.nn.Module, batch: Dict, cfg: ModelConfig, *,
            data=None, model=None) -> torch.Tensor:
    """The training loss of ``batch`` (``tokens``, ``labels`` (-1 = not
    scored) and, by family, ``frames`` / ``patch_embeds`` / ``pos3``): a
    float32 scalar.  With ``data`` (the data group's ``Comm``), ``batch``
    is this rank's rows of the global batch and the value is this rank's
    term: the ranks' terms, and their gradients, sum to those of the
    global batch (``data=None``: one device, the whole batch).  With
    ``model`` (the model group's ``Comm``; ``lm`` holds this rank's
    slices, ``init_model(..., slices=)``), every rank of the group
    computes its part of each layer, and the value is the same on each:
    it is not summed over the group.  Every family takes a model axis;
    a leaf no rule slices (mamba2's mixer at full width) is computed
    whole on every rank of the group, its gradient whole on each."""
    if cfg.family in ("dense", "moe", "vlm"):
        return T.decoder_loss(lm, batch, cfg, data, model)
    if cfg.family == "encdec":
        return T.encdec_loss(lm, batch, cfg, data, model)
    if cfg.family == "hybrid":
        return T.hybrid_loss(lm, batch, cfg, data, model)
    if cfg.family == "ssm":
        return T.ssm_loss(lm, batch, cfg, data, model)
    raise ValueError(cfg.family)


def hidden_fn(model: torch.nn.Module, batch: Dict, cfg: ModelConfig
              ) -> torch.Tensor:
    """The final hidden states (b, s, d) of ``batch``."""
    if cfg.family in ("dense", "moe", "vlm"):
        return T.decoder_hidden(model, batch["tokens"], cfg,
                                pos3=batch.get("pos3"),
                                patch_embeds=batch.get("patch_embeds"))
    if cfg.family == "encdec":
        return T.encdec_hidden(model, batch["frames"], batch["tokens"], cfg)
    if cfg.family == "hybrid":
        return T.hybrid_hidden(model, batch["tokens"], cfg)
    if cfg.family == "ssm":
        return T.ssm_hidden(model, batch["tokens"], cfg)
    raise ValueError(cfg.family)
