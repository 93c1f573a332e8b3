"""Shared inputs and checks of the training-path tests of the port
(``tests/test_torch_loss*.py``, ``tests/test_torch_train.py``).

Weights are the JAX package's SMOKE init carried across with
``interop.params_from_jax``; batches are drawn with numpy.  The
reference runs eagerly on the CPU.  Tolerances (float32): hidden states
and losses within 1e-5 relative; each gradient leaf within 1e-4 of the
leaf's max |g| (the two packages sum in other orders, and a leaf whose
gradient is near 0 has no meaningful relative error element by
element).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import hidden_fn as j_hidden_fn
from repro.models import init_model as j_init_model
from repro.models import loss_fn as j_loss_fn
from repro_torch import configs
from repro_torch.data import random_batch
from repro_torch.interop import params_from_jax, tensors_from_jax
from repro_torch.models import hidden_fn, loss_fn

HIDDEN_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def smoke_pair(arch, **overrides):
    """(JAX config, port config, JAX params, port model on the CPU)."""
    jcfg = jconfigs.get_smoke(arch).replace(**overrides)
    cfg = configs.get_smoke(arch).replace(**overrides)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_jax(params, cfg, device="cpu")


def reference_batch(cfg, seed=0):
    """The reference's ``test_train`` batch: 4 x 64 tokens (labels =
    tokens)."""
    tokens = np.random.default_rng(seed).integers(1, cfg.vocab, (4, 64))
    return tokens.astype(np.int32)


def smoke_training():
    """(config, AdamW config, model, optimizer state, batch) of the
    port's llama SMOKE training tests, on the CPU."""
    from repro_torch.models import init_model
    from repro_torch.train import AdamWConfig, init_opt_state
    cfg = configs.get_smoke("llama3_8b")
    ocfg = AdamWConfig(lr=1e-3, warmup=2, total_steps=100)
    model = init_model(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(reference_batch(cfg, seed=1))
    return cfg, ocfg, model, init_opt_state(model, ocfg), \
        {"tokens": tokens, "labels": tokens}


def jax_batch(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def torch_batch(nb, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in nb.items()}


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def port_grads(model, batch, cfg):
    """(loss, {name: grad}) of the port's ``loss_fn``."""
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, batch, cfg)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def check_loss_and_grads(arch):
    """``hidden_fn``, ``loss_fn`` and every gradient of ``arch``'s SMOKE
    model against the JAX package's."""
    jcfg, cfg, params, model = smoke_pair(arch)
    nb = random_batch(cfg)
    jb, tb = jax_batch(nb), torch_batch(nb)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: j_loss_fn(p, jb, jcfg))(params)
    with torch.no_grad():
        h = hidden_fn(model, tb, cfg)
    assert rel_err(h.numpy(), j_hidden_fn(params, jb, jcfg)) <= HIDDEN_RTOL
    loss, grads = port_grads(model, tb, cfg)
    assert abs(float(loss) - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
    want = tensors_from_jax(j_grads, cfg, device="cpu")
    assert set(grads) == set(want)
    errs = {n: rel_err(g.numpy(), want[n].numpy()) for n, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
