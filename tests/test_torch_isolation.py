"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import Balancer, BalanceSpec
from repro_torch.distributed import run_world
from repro_torch.fem import AdaptiveSession, AdaptSpec
from repro_torch.models import init_model
from repro_torch.serve import ServeSession, ServeSpec

import _torch_world as W

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.fem, "
            "repro_torch.kernels, repro_torch.interop, repro_torch.telemetry, "
            "repro_torch.configs, repro_torch.data, repro_torch.models, "
            "repro_torch.serve, repro_torch.train, repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_cuda(tmp_path):
    cfg = get_smoke("llama3_8b").replace(n_layers=1, d_model=32, d_ff=64,
                                         vocab=64)
    spec = ServeSpec(decode="replicated", rebalance="tags")
    rdv = str(tmp_path / "rdv")
    if torch.cuda.is_available():
        assert Balancer(BalanceSpec(p=4)).device.type == "cuda"
        assert AdaptiveSession(AdaptSpec()).device.type == "cuda"
        model = init_model(cfg)
        assert model.ln_f.is_cuda
        assert ServeSession(model, cfg, spec).device.type == "cuda"
        assert run_world(W.device_of, 2, init_file=rdv) == ["cuda:0"] * 2
        return
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        run_world(W.device_of, 2, init_file=rdv)
    assert not os.path.exists(rdv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Balancer(BalanceSpec(p=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaptiveSession(AdaptSpec())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg)
    model = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession(model, cfg, spec)
    assert Balancer(BalanceSpec(p=4), device="cpu").device.type == "cpu"
    assert AdaptiveSession(AdaptSpec(), device="cpu").device.type == "cpu"
    assert ServeSession(model, cfg, spec, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch,prefill", [("whisper_medium", "cheap"),
                                          ("qwen2_vl_72b", "full")])
def test_encdec_and_vlm_stand_alone_and_default_to_cuda(arch, prefill):
    """The encoder-decoder and VLM modules are among the files checked
    above, and their entry points run on CUDA unless asked for the CPU."""
    assert {f"{arch}.py", "transformer.py", "decode.py"} <= {
        p.name for p in PORT_FILES}
    cfg = get_smoke(arch)
    spec = ServeSpec(prefill=prefill, decode="replicated", rebalance="tags")
    if torch.cuda.is_available():
        model = init_model(cfg)
        assert model.ln_f.is_cuda
        assert ServeSession(model, cfg, spec).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg)
    model = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession(model, cfg, spec)
    assert ServeSession(model, cfg, spec, device="cpu").device.type == "cpu"


def test_training_stands_alone_and_defaults_to_cuda(tmp_path):
    """The training modules are among the files checked above, and the
    training entry points (the packer's balancer, the launcher's loop)
    run on CUDA unless asked for the CPU."""
    import numpy as np
    from repro_torch.data import balanced_pack
    from repro_torch.launch.train import train
    assert {"optimizer.py", "compress.py", "checkpoint.py", "train_step.py",
            "train.py", "packing.py"} <= {p.name for p in PORT_FILES}
    cfg = get_smoke("llama3_8b")
    lengths = np.arange(8, 72)
    if torch.cuda.is_available():
        assert balanced_pack(lengths, 4)[0].shape == lengths.shape
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        balanced_pack(lengths, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, steps=1, ckpt=None, log=lambda *a: None)
    rows, _ = balanced_pack(lengths, 4, device="cpu")
    assert rows.shape == lengths.shape
    out = train(cfg, steps=1, batch=2, seq=64, ckpt=str(tmp_path / "ck"),
                device="cpu", log=lambda *a: None)
    assert out["model"].ln_f.device.type == "cpu"


def test_sharded_session_names_the_roadmap_item():
    """The sharded session is ported (ROADMAP queue 1, item 9) and fails
    fast, as the JAX package's does, without a process group of p ranks
    (tests/test_torch_halo.py runs it)."""
    spec = AdaptSpec(backend="sharded",
                     balance=BalanceSpec(p=4, backend="sharded"))
    with pytest.raises(ValueError, match="process group"):
        AdaptiveSession(spec, device="cpu")


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    """No CUDA: exits non-zero and prints no result line.  Alone in a
    directory: cannot import the port, exits non-zero."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
