"""Checkpoints and the training launcher of the port, on the CPU: the
JAX package's on-disk layout in both directions (a JAX-written
checkpoint, float32 and bf16, restored by ``interop.checkpoint_from_jax``
gives the reference's next loss: 1e-5 relative in float32, 2e-2 in bf16,
whose forwards round differently in the two packages), the port's own
round trip bit for bit, and ``launch.train``: training, checkpointing
and resuming equal to an unbroken run.  On a gloo world of 4 CPU ranks,
a checkpoint written on a (data, model) mesh of 2x2 moves to 4x1, to
one rank and back to 2x2, each mesh's own save of it equal bit for bit
in the one-rank layout."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_training import reference_batch, smoke_pair, smoke_training
from repro.train import (AdamWConfig as JAdamWConfig,
                         init_opt_state as j_init_opt_state,
                         make_train_step as j_make_train_step, save as j_save)
from repro_torch.interop import checkpoint_from_jax, tensors_from_jax
from repro_torch.launch import train as launch
from repro_torch.models import init_model
from repro_torch.train import (AdamWConfig, AsyncCheckpointer, OptState,
                               init_opt_state, latest_step, make_train_step,
                               restore, save)


def test_checkpoint_roundtrip_and_latest(tmp_path):
    cfg, ocfg, model, opt, batch = smoke_training()
    model, opt, _ = make_train_step(cfg, ocfg)(model, opt, batch)
    state = {"params": model, "opt": opt}
    d = str(tmp_path)
    save(d, 3, state)
    save(d, 7, state)
    ck = AsyncCheckpointer()
    ck.save_async(d, 9, state)
    ck.wait()
    assert latest_step(d) == 9
    fresh = init_model(cfg, seed=5, device="cpu")
    template = {"params": fresh, "opt": init_opt_state(fresh, ocfg)}
    step, restored = restore(d, template=template)
    assert step == 9 and restored["params"] is fresh
    assert isinstance(restored["opt"], OptState)
    assert restored["opt"].step == opt.step == 1
    for n, p in model.named_parameters():
        assert torch.equal(dict(fresh.named_parameters())[n], p)
        assert torch.equal(restored["opt"].m[n], opt.m[n])
        assert torch.equal(restored["opt"].v[n], opt.v[n])
    _, flat = restore(d, step=3)
    assert set(flat) == {f"params/{n}" for n, _ in model.named_parameters()} \
        | {"opt/0"} | {f"opt/{i}/{n}" for i in (1, 2)
                       for n, _ in model.named_parameters()}


def test_bf16_checkpoint_files_are_written_like_jax(tmp_path):
    """A bf16 leaf is raw 2-byte words with descr '<V2' and dtype
    'bfloat16' in the manifest, in both packages."""
    import json
    x = torch.randn(3, 5).to(torch.bfloat16)
    save(str(tmp_path / "t"), 1, {"w": x})
    j_save(str(tmp_path / "j"), 1, {"w": jnp.asarray(x.float().numpy()
                                                     ).astype(jnp.bfloat16)})
    for side in ("t", "j"):
        d = tmp_path / side / "step_00000001"
        meta = json.loads((d / "manifest.json").read_text())["arrays"]["w"]
        assert meta["dtype"] == "bfloat16" and meta["file"] == "w.npy"
        assert b"'descr': '<V2'" in (d / "w.npy").read_bytes()[:80]
    assert (tmp_path / "t" / "step_00000001" / "w.npy").read_bytes() == \
        (tmp_path / "j" / "step_00000001" / "w.npy").read_bytes()
    _, flat = restore(str(tmp_path / "j"))
    assert torch.equal(flat["w"], x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, dtype):
    """The JAX launcher's layout ({"params", "opt"}) after two JAX steps,
    restored by ``checkpoint_from_jax``: the parameters and both moments
    equal the JAX arrays bit for bit, leaf by leaf, and after one update
    from the restored state (which reads the moments) the next loss
    equals the reference's (1e-5 relative in float32; bf16 within 2e-2,
    the two packages' bf16 forwards round differently)."""
    overrides = {} if dtype == "float32" else dict(dtype="bfloat16",
                                                   param_dtype="bfloat16")
    jcfg, cfg, params, _ = smoke_pair("llama3_8b", **overrides)
    kw = dict(lr=1e-3, warmup=2, total_steps=100, adam_dtype=dtype)
    jo, o = JAdamWConfig(**kw), AdamWConfig(**kw)
    tokens = reference_batch(cfg)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    jstep = j_make_train_step(jcfg, jo)
    jopt = j_init_opt_state(params, jo)
    for _ in range(2):
        params, jopt, _ = jstep(params, jopt, jb)
    j_save(str(tmp_path), 2, {"params": params, "opt": jopt})
    step, model, opt = checkpoint_from_jax(str(tmp_path), cfg, device="cpu")
    assert step == 2 and opt.step == 2
    want = tensors_from_jax(params, cfg, device="cpu")
    want_m = tensors_from_jax(jopt.m, cfg, device="cpu")
    want_v = tensors_from_jax(jopt.v, cfg, device="cpu")
    assert set(opt.m) == set(opt.v) == set(want)
    for n, p in model.named_parameters():
        assert p.dtype == cfg.p_dtype and torch.equal(p, want[n]), n
        assert opt.m[n].dtype == opt.v[n].dtype == getattr(torch, dtype)
        assert torch.equal(opt.m[n], want_m[n]), n
        assert torch.equal(opt.v[n], want_v[n]), n
    params, jopt, _ = jstep(params, jopt, jb)
    _, _, jm = jstep(params, jopt, jb)
    tb = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(tokens)}
    step_fn = make_train_step(cfg, o)
    model, opt, _ = step_fn(model, opt, tb)
    _, _, m = step_fn(model, opt, tb)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert abs(float(m["loss"]) - float(jm["loss"])) <= tol * float(jm["loss"])


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "llama3_8b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "64", "--ckpt", ck, "--ckpt-every", "2"]
    out = launch.main(argv + ["--steps", "4"])
    assert out["start"] == 0 and len(out["history"]) == 4
    assert latest_step(ck) == 4
    rec = out["history"][0]
    assert np.isfinite(rec["loss"]) and rec["loss"] < 2 * np.log(512)
    assert min(rec["t_pack"], rec["t_grad"], rec["t_update"]) > 0.0
    again = launch.main(argv + ["--steps", "6"])
    assert again["start"] == 4 and [r["step"] for r in again["history"]] \
        == [4, 5]
    assert again["opt"].step == 6 and latest_step(ck) == 6
    text = capsys.readouterr().out
    assert "resumed from step 4" in text and "step    5 loss=" in text
    with pytest.raises(ValueError, match=r"rglru\.in_x.*3 model ranks"):
        launch.main(["--arch", "recurrentgemma_2b", "--device", "cpu",
                     "--mesh", "2x3", "--ckpt", ck])


def test_resume_continues_like_an_unbroken_run(tmp_path):
    """Three steps with a checkpoint after the second; a run resumed from
    it takes the third step again and ends with the same parameters (the
    same batches: the resumed run packs from the first document again,
    the reference's behaviour, so its batches are given here)."""
    from repro_torch import configs
    cfg = configs.get_smoke("llama3_8b")
    tokens = reference_batch(cfg)
    batches = lambda: iter([{"tokens": tokens, "labels": tokens}] * 3)  # noqa
    kw = dict(steps=3, batch=4, seq=64, lr=1e-3, device="cpu", log=lambda *a:
              None)
    ck = str(tmp_path / "ck")
    whole = launch.train(cfg, ckpt=ck, ckpt_every=2, batches=batches(), **kw)
    assert latest_step(ck) == 2 and whole["opt"].step == 3
    resumed = launch.train(cfg, ckpt=ck, ckpt_every=100, batches=batches(),
                           **kw)
    assert resumed["start"] == 2 and resumed["opt"].step == 3
    for (n, p), q in zip(whole["model"].named_parameters(),
                         resumed["model"].parameters()):
        assert torch.equal(p, q), n


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    import _torch_world as W
    from repro_torch import configs
    from repro_torch.data import random_batch
    cfg = configs.get_smoke("llama3_8b")
    batches = [random_batch(cfg, b=4, s=64, seed=300 + i) for i in range(3)]
    ranks = W.world(W.elastic_mesh, batches,
                    str(tmp_path_factory.mktemp("mesh_ckpt")),
                    tmp_path=tmp_path_factory.mktemp("mesh"), p=4)
    return ranks


def test_elastic_checkpoint_moves_between_meshes(elastic):
    """Saved at 2x2 (the model slices and their ZeRO'd moments gathered
    into the one-rank layout), restored and saved again at 4x1, at 1x1
    and at 2x2: every array equal bit for bit to the first save; a run
    resumed at 4x1 or at 1x1 starts at step 2, and the two take the next
    step alike (within 1e-6: the data ranks sum their rows in another
    order)."""
    from repro_torch.train.checkpoint import read_checkpoint
    dirs = elastic[0]["dirs"]
    step, want = read_checkpoint(dirs["2x2"])
    assert step == 2 and len(want) > 1
    for k in ("4x1", "1x1", "2x2b"):
        got_step, got = read_checkpoint(dirs[k])
        assert got_step == 2 and set(got) == set(want), k
        for n, w in want.items():
            assert got[n].dtype == w.dtype and torch.equal(got[n], w), (k, n)
    resumed = elastic[0]["resumed"]
    assert resumed[4]["start"] == resumed[1]["start"] == 2
    for n, w in resumed[1]["params"].items():
        assert np.max(np.abs(resumed[4]["params"][n] - w)) <= 1e-6, n
