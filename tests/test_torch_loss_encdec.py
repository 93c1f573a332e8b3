"""The training loss of the encoder-decoder family (whisper) against the
JAX package, on the CPU (float32 SMOKE config; tolerances in
``tests/_torch_training.py``): ``loss_fn`` / ``hidden_fn`` and every
gradient, the cross-attention's through the encoder, and remat over
both stacks."""
import torch

from _torch_training import (check_loss_and_grads, port_grads, smoke_pair,
                             torch_batch)
from repro_torch.data import random_batch


def test_loss_hidden_and_grads_match_jax():
    check_loss_and_grads("whisper_medium")


def test_remat_gives_the_same_bits():
    _, cfg, _, model = smoke_pair("whisper_medium")
    tb = torch_batch(random_batch(cfg))
    loss, grads = port_grads(model, tb, cfg)
    loss_r, grads_r = port_grads(model, tb, cfg.replace(remat=True))
    assert torch.equal(loss, loss_r)
    for n, g in grads.items():
        assert torch.equal(g, grads_r[n]), n
