"""The training loss of the SSM (mamba2) and hybrid (recurrentgemma)
families against the JAX package, on the CPU (float32 SMOKE configs;
tolerances in ``tests/_torch_training.py``): ``loss_fn`` / ``hidden_fn``
and every gradient, and remat on the SSM (the reference unrolls the
hybrid's layers without it); whisper: ``test_torch_loss_encdec.py``."""
import pytest
import torch

from _torch_training import (check_loss_and_grads, port_grads, smoke_pair,
                             torch_batch)
from repro_torch.data import random_batch


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "recurrentgemma_2b"])
def test_loss_hidden_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_remat_gives_the_same_bits():
    _, cfg, _, model = smoke_pair("mamba2_1_3b")
    tb = torch_batch(random_batch(cfg))
    loss, grads = port_grads(model, tb, cfg)
    loss_r, grads_r = port_grads(model, tb, cfg.replace(remat=True))
    assert torch.equal(loss, loss_r)
    for n, g in grads.items():
        assert torch.equal(g, grads_r[n]), n
