"""The training loss of the MoE family (phi3.5-moe, grok-1) against the
JAX package, on the CPU (float32 SMOKE configs; tolerances in
``tests/_torch_training.py``): ``loss_fn`` / ``hidden_fn`` and every
gradient -- the router's through the gates and the aux term, the
experts' through the dispatch scatter -- and the aux loss itself."""
import pytest
import torch

from _torch_training import (HIDDEN_RTOL, LOSS_RTOL, check_loss_and_grads,
                             jax_batch, port_grads, smoke_pair, torch_batch)
from repro.models import transformer as JT
from repro_torch.data import random_batch
from repro_torch.models import loss_fn
from repro_torch.models import transformer as TT


@pytest.mark.parametrize("arch", ["phi35_moe_42b", "grok_1_314b"])
def test_loss_hidden_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_moe_aux_is_summed_over_layers_and_weighted_like_jax():
    """``decoder_hidden(..., with_aux=True)`` returns the aux loss summed
    over the layers, equal to the reference's; the loss adds 0.01 of it
    to the masked CE."""
    jcfg, cfg, params, model = smoke_pair("phi35_moe_42b")
    nb = random_batch(cfg)
    tb = torch_batch(nb)
    with torch.no_grad():
        x, aux = TT.decoder_hidden(model, tb["tokens"], cfg, with_aux=True)
        assert torch.equal(TT.decoder_hidden(model, tb["tokens"], cfg), x)
        ce = TT._masked_ce(model.embed.head, x, tb["labels"], cfg)
        loss = loss_fn(model, tb, cfg)
    jx, jaux = JT.decoder_hidden(params, jax_batch(nb)["tokens"], jcfg)
    assert float(aux) > 0.0
    assert abs(float(aux) - float(jaux)) <= HIDDEN_RTOL * float(jaux)
    assert abs(float(loss) - float(ce + 0.01 * aux)) <= LOSS_RTOL * float(loss)


def test_dense_aux_is_zero_and_serving_signature_kept():
    _, cfg, _, model = smoke_pair("llama3_8b")
    tb = torch_batch(random_batch(cfg))
    with torch.no_grad():
        x, aux = TT.decoder_hidden(model, tb["tokens"], cfg, with_aux=True)
        assert float(aux) == 0.0 and aux.dtype == torch.float32
        assert torch.equal(TT.decoder_hidden(model, tb["tokens"], cfg), x)


def test_router_gradient_comes_through_gates_and_aux():
    """The router's gradient is non-zero with the aux term and without it
    (the gates alone), and the expert weights get gradients through the
    dispatch scatter."""
    _, cfg, _, model = smoke_pair("grok_1_314b")
    tb = torch_batch(random_batch(cfg))
    _, grads = port_grads(model, tb, cfg)
    for li in range(cfg.n_layers):
        for w in ("router", "wi", "wg", "wo"):
            assert float(grads[f"layers.{li}.moe.{w}"].abs().max()) > 0.0
    model.requires_grad_(True)
    x = TT.decoder_hidden(model, tb["tokens"], cfg)
    ce = TT._masked_ce(model.embed.head, x, tb["labels"], cfg)
    (g,) = torch.autograd.grad(ce, [model.layers[0].moe.router])
    assert float(g.abs().max()) > 0.0
