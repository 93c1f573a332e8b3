"""The training substrate against the JAX package, on the CPU: the
learning-rate schedule, AdamW, error-feedback compression (and its
int8 all-gather sum over a 4-rank gloo world) and the train step
(checkpoints and the launcher: ``tests/test_torch_checkpoint.py``).

Tolerances, float32: the schedule within 2 ulps (XLA's float32 cosine
and torch's differ in the last bit at 5 of the 101 steps checked, as
neither rounds correctly everywhere; everything else in it is equal);
one AdamW update from identical parameters, moments and gradients within 1e-6
(absolute; the parameters are O(0.1), and gnorm sums its leaves in
another order); quantization bit for bit; the int8 sum within the
reference's 5 % of the exact sum and 1e-6 of the reference's own; 8
train steps' losses within 1e-3 relative of the reference's (gradients
differ in the last bits and AdamW's first steps move each weight by
about lr times the sign of its gradient, so the trajectories drift
apart slowly)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_training import reference_batch, smoke_pair, smoke_training
import _torch_world as W
from repro.distributed.sharding import Boxed
from repro.train import (AdamWConfig as JAdamWConfig, adamw_update as
                         j_adamw_update, compressed_psum as j_compressed_psum,
                         ef_compress_grads as j_ef_compress_grads,
                         init_compress_state as j_init_compress_state,
                         init_opt_state as j_init_opt_state,
                         lr_schedule as j_lr_schedule,
                         make_train_step as j_make_train_step)
from repro.train.compress import _quantize as j_quantize
from repro_torch.interop import opt_state_from_jax, tensors_from_jax
from repro_torch.train import (AdamWConfig, adamw_update, ef_compress_grads,
                               init_compress_state, init_opt_state,
                               lr_schedule, make_train_step)
from repro_torch.train.compress import _quantize

UPDATE_TOL = 1e-6
LR_ULPS = 2 * float(np.finfo(np.float32).eps)
TRAJECTORY_RTOL = 1e-3


def _lr_close(got, want):
    return abs(float(got) - float(want)) <= LR_ULPS * abs(float(want))


def _jax_grads_like(params, seed, scale=1.0):
    """Random gradients in the reference's tree (numpy-seeded)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda b: Boxed(jnp.asarray((rng.standard_normal(b.value.shape)
                                     * scale).astype(np.float32)
                                    ).astype(b.value.dtype), b.axes),
        params, is_leaf=lambda x: isinstance(x, Boxed))


def test_lr_schedule_equals_jax():
    for ocfg in (AdamWConfig(lr=1.0, warmup=10, total_steps=100),
                 AdamWConfig(lr=3e-4, warmup=1, total_steps=7)):
        j = JAdamWConfig(**ocfg.__dict__)
        for s in range(0, 101):
            got = lr_schedule(ocfg, s)
            assert got.dtype == torch.float32
            assert _lr_close(got, j_lr_schedule(j, jnp.asarray(s))), s


def test_lr_schedule_shape():
    ocfg = AdamWConfig(lr=1.0, warmup=10, total_steps=100)
    lrs = [float(lr_schedule(ocfg, s)) for s in range(0, 101, 10)]
    assert lrs[0] < lrs[1]                  # warmup
    assert lrs[-1] < lrs[2]                 # decay
    assert all(l <= 1.0 + 1e-6 for l in lrs)


@pytest.mark.parametrize("adam_dtype,grad_scale", [
    ("float32", 1.0), ("float32", 1e-4), ("bfloat16", 1e-4)])
def test_adamw_update_with_identical_grads_matches_jax(adam_dtype, grad_scale,
                                                       monkeypatch):
    """Three updates from the same parameters with the same gradients; a
    small update chunk so that a leaf is updated in several slices.  At
    grad_scale 1 the norm is above clip_norm and clipping acts: the clip
    scale then differs in ulps (gnorm sums the leaves in another order),
    which a bf16 moment can turn into one bf16 ulp, so the bf16 case
    keeps the norm below clip_norm (scale exactly 1 in both)."""
    from repro_torch.train import optimizer
    monkeypatch.setattr(optimizer, "UPDATE_CHUNK", 4096)
    jcfg, cfg, params, model = smoke_pair("llama3_8b")
    kw = dict(lr=1e-2, warmup=2, total_steps=10, adam_dtype=adam_dtype)
    jo, o = JAdamWConfig(**kw), AdamWConfig(**kw)
    jstate, state = j_init_opt_state(params, jo), init_opt_state(model, o)
    for i in range(3):
        jg = _jax_grads_like(params, i, grad_scale)
        params, jstate, jinfo = j_adamw_update(params, jg, jstate, jo)
        state, info = adamw_update(model, tensors_from_jax(jg, cfg,
                                                           device="cpu"),
                                   state, o)
        assert abs(float(info["gnorm"]) - float(jinfo["gnorm"])) <= \
            1e-6 * float(jinfo["gnorm"])
        assert _lr_close(info["lr"], jinfo["lr"])
    assert state.step == int(jstate.step) == 3
    want_p = tensors_from_jax(params, cfg, device="cpu")
    want = opt_state_from_jax(jstate, cfg, device="cpu")
    for n, p in model.named_parameters():
        assert float((p - want_p[n]).abs().max()) <= UPDATE_TOL, n
        for got_t, want_t in ((state.m, want.m), (state.v, want.v)):
            assert got_t[n].dtype == getattr(torch, adam_dtype)
            err = (got_t[n].float() - want_t[n].float()).abs().max()
            assert float(err) <= UPDATE_TOL, n


@pytest.mark.parametrize("arch", ["llama3_8b", "recurrentgemma_2b"])
def test_quantize_and_error_feedback_are_bit_for_bit(arch):
    """One scale per leaf of the reference's tree: a stacked parameter's
    layers share it (llama), the hybrid's list layers do not."""
    jcfg, cfg, params, model = smoke_pair(arch)
    jstate = j_init_compress_state(params)
    state = init_compress_state(model)
    for i in range(3):
        jg = _jax_grads_like(params, 10 + i)
        jdeq, jstate = j_ef_compress_grads(jg, jstate)
        deq, state = ef_compress_grads(tensors_from_jax(jg, cfg,
                                                        device="cpu"),
                                       state, cfg)
        want_g = tensors_from_jax(jdeq, cfg, device="cpu")
        want_e = tensors_from_jax(jstate.err, cfg, device="cpu")
        for n in want_g:
            assert torch.equal(deq[n], want_g[n]), n
            assert torch.equal(state.err[n], want_e[n]), n
    x = np.random.default_rng(5).standard_normal(1000).astype(np.float32)
    q, s = _quantize(torch.as_tensor(x))
    jq, js = j_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


@pytest.fixture(scope="module")
def compressed_world(tmp_path_factory):
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal((4, 128)).astype(np.float32),
          (rng.standard_normal((4, 3, 50)) * 1e-3).astype(np.float32)]
    out = W.world(W.compressed_sums, xs,
                  tmp_path=tmp_path_factory.mktemp("compressed"))
    return xs, out


@pytest.mark.parametrize("case", [0, 1])
def test_compressed_psum_over_four_ranks(compressed_world, case):
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed.sharding import shard_map
    xs, out = compressed_world
    x = xs[case]
    for r in range(1, 4):
        np.testing.assert_array_equal(out[r][case], out[0][case])
    got = out[0][case]
    want = x.sum(axis=0)
    assert np.abs(got - want).max() / np.abs(want).max() < 0.05
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    f = shard_map(lambda xs_: j_compressed_psum(xs_[0], "x")[None],
                  mesh=mesh, in_specs=P("x"), out_specs=P("x"))
    ref = np.asarray(f(jnp.asarray(x)))[0]
    assert np.abs(got - ref).max() <= UPDATE_TOL * np.abs(ref).max()


def test_train_step_trajectory_matches_jax():
    jcfg, cfg, params, model = smoke_pair("llama3_8b")
    kw = dict(lr=1e-3, warmup=2, total_steps=100)
    jo, o = JAdamWConfig(**kw), AdamWConfig(**kw)
    tokens = reference_batch(cfg)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    tb = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(tokens)}
    jstep = jax.jit(j_make_train_step(jcfg, jo))
    step = make_train_step(cfg, o)
    jopt, opt = j_init_opt_state(params, jo), init_opt_state(model, o)
    for i in range(8):
        params, jopt, jm = jstep(params, jopt, jb)
        model, opt, m = step(model, opt, tb)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            TRAJECTORY_RTOL * float(jm["loss"]), i
        assert abs(float(m["gnorm"]) - float(jm["gnorm"])) <= \
            TRAJECTORY_RTOL * float(jm["gnorm"]), i


def test_train_memorizes():
    cfg, ocfg, model, opt, batch = smoke_training()
    step = make_train_step(cfg, ocfg)
    times = {}
    losses = []
    for _ in range(8):
        model, opt, m = step(model, opt, batch, times=times)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0
    assert all(np.isfinite(losses))
    assert times["grad"] > 0.0 and times["update"] > 0.0


def test_compressed_training_converges():
    """Error-feedback int8 grads still reduce the loss."""
    cfg, ocfg, model, opt, batch = smoke_training()
    step = make_train_step(cfg, ocfg, compress=True)
    comp = init_compress_state(model)
    losses = []
    for _ in range(8):
        model, opt, comp, m = step(model, opt, batch, comp)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0


def test_attention_kernels_refuse_inputs_that_require_grad():
    """The CUDA wrappers have no backward: inputs that require grad raise
    before anything else (here, before the device check), and under
    ``no_grad`` the same tensors reach the usual checks."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.serve_prefill import packed_attention_cuda
    q = torch.randn(1, 4, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        packed_attention_cuda(q[0], k[0], k[0],
                              torch.zeros(8, dtype=torch.int32))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
