"""The training loss and hidden states of the dense family and the VLM
against the JAX package, on the CPU (float32 SMOKE configs; tolerances
in ``tests/_torch_training.py``): ``loss_fn`` / ``hidden_fn`` and every
gradient, remat, the VLM's label padding, ``_masked_ce``'s ragged tail
and ``chunked_cross_entropy``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_training import (LOSS_RTOL, check_loss_and_grads, port_grads,
                             smoke_pair, torch_batch)
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.data import random_batch
from repro_torch.models import layers as TL
from repro_torch.models import loss_fn
from repro_torch.models import transformer as TT

ARCHS = ["llama3_8b", "h2o_danube3_4b", "h2o_danube_1_8b",
         "command_r_plus_104b", "qwen2_vl_72b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_hidden_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_remat_gives_the_same_bits():
    """``torch.utils.checkpoint`` under ``remat`` recomputes each layer in
    the backward pass: loss and gradients equal bit for bit."""
    _, cfg, _, model = smoke_pair("llama3_8b")
    tb = torch_batch(random_batch(cfg))
    loss, grads = port_grads(model, tb, cfg)
    loss_r, grads_r = port_grads(model, tb, cfg.replace(remat=True))
    assert torch.equal(loss, loss_r)
    for n, g in grads.items():
        assert torch.equal(g, grads_r[n]), n


def test_remat_runs_through_checkpoint_only_with_grad(monkeypatch):
    calls = []
    real = TT.checkpoint
    monkeypatch.setattr(TT, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, cfg, _, model = smoke_pair("llama3_8b", remat=True)
    tb = torch_batch(random_batch(cfg))
    with torch.no_grad():
        loss_fn(model, tb, cfg)
    assert calls == []
    port_grads(model, tb, cfg)
    assert len(calls) == cfg.n_layers


def test_vlm_labels_are_padded_over_the_patches():
    _, cfg, _, model = smoke_pair("qwen2_vl_72b")
    tb = torch_batch(random_batch(cfg))
    n_p = cfg.vision_patches
    with torch.no_grad():
        x = TT.decoder_hidden(model, tb["tokens"], cfg,
                              patch_embeds=tb["patch_embeds"])
        pad = torch.full((2, n_p), -1, dtype=tb["labels"].dtype)
        want = TT._masked_ce(model.embed.head, x,
                             torch.cat([pad, tb["labels"]], 1), cfg)
        assert torch.equal(loss_fn(model, tb, cfg), want)
        assert x.shape[1] == n_p + tb["labels"].shape[1]


@pytest.mark.parametrize("s,chunk,scored", [(200, 64, 198), (64, 64, 64),
                                            (100, 512, 100)])
def test_masked_ce_drops_the_ragged_tail_like_jax(s, chunk, scored):
    """nc = max(s // loss_chunk, 1) chunks of s // nc positions: the
    positions past nc * (s // nc) are never scored (s = 200 with chunks
    of 64 scores 198), in both packages."""
    cfg = configs.get_smoke("llama3_8b").replace(loss_chunk=chunk)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    head = rng.standard_normal((cfg.d_model, cfg.vocab)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab, (2, s)).astype(np.int32)
    got = TT._masked_ce(torch.as_tensor(head), torch.as_tensor(x),
                        torch.as_tensor(labels), cfg)
    want = JT._masked_ce(JL.box(jnp.asarray(head), ("embed", "vocab")),
                         jnp.asarray(x), jnp.asarray(labels), cfg)
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    tail = labels.copy()
    tail[:, scored:] = rng.integers(0, cfg.vocab, (2, s - scored))
    again = TT._masked_ce(torch.as_tensor(head), torch.as_tensor(x),
                          torch.as_tensor(tail), cfg)
    assert torch.equal(got, again)
    if scored < s:
        tail[:, scored - 1] = (tail[:, scored - 1] + 1) % cfg.vocab
        moved = TT._masked_ce(torch.as_tensor(head), torch.as_tensor(x),
                              torch.as_tensor(tail), cfg)
        assert not torch.equal(got, moved)


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 512)])
def test_chunked_cross_entropy_matches_jax(s, chunk):
    cfg = configs.get_smoke("llama3_8b").replace(loss_chunk=chunk)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)
    head = rng.standard_normal((cfg.d_model, cfg.vocab)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (3, s)).astype(np.int32)
    got = TL.chunked_cross_entropy(torch.as_tensor(head), torch.as_tensor(x),
                                   torch.as_tensor(labels), cfg)
    want = JL.chunked_cross_entropy(
        JL.box(jnp.asarray(head), ("embed", "vocab")), jnp.asarray(x),
        jnp.asarray(labels), cfg)
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
