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
EXAMPLE_FILES = sorted((ROOT / "examples" / "torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "attention_rows.py"] + EXAMPLE_FILES


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
            "repro_torch.serve, repro_torch.train, repro_torch.launch.train, "
            "repro_torch.launch.mesh, repro_torch.distributed.sharding, "
            "repro_torch.telemetry.smoke, repro_torch.core.graph_greedy, "
            "repro_torch.deprecation, repro_torch.core.balancer, "
            "repro_torch.distributed.balancer, repro_torch.launch, "
            "importlib.util; "
            "[importlib.util.spec_from_file_location(p.stem, p).loader"
            ".exec_module(importlib.util.module_from_spec("
            "importlib.util.spec_from_file_location(p.stem, p))) "
            "for p in map(__import__('pathlib').Path, sys.argv[1:])]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code,
                          *map(str, EXAMPLE_FILES)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(EXAMPLE_FILES) == 5


def test_legacy_shims_and_examples_stand_alone_and_default_to_cuda(tmp_path):
    """The deprecated shims and the examples are among the files checked
    above; the shims' entry points (``DynamicLoadBalancer``,
    ``ServeEngine``, the FEM drivers, ``peak_init``) and the examples'
    ``main`` run on CUDA unless asked for the CPU, and without a card the
    default raises (no fallback)."""
    import warnings
    from repro_torch.core import DynamicLoadBalancer
    from repro_torch.fem import (ParabolicProblem, peak_init,
                                 solve_helmholtz_adaptive,
                                 solve_parabolic_adaptive, unit_cube_mesh)
    from repro_torch.serve import ServeEngine
    assert {"deprecation.py", "balancer.py"} <= {p.name for p in PORT_FILES}
    assert {"quickstart.py", "parallel_fem.py", "serve_continuous.py",
            "moe_balance.py", "train_lm.py"} == {p.name for p in EXAMPLE_FILES}
    cfg = get_smoke("llama3_8b").replace(n_layers=1, d_model=32, d_ff=64,
                                         vocab=64)
    w, xyz = torch.ones(64), torch.rand(64, 3)
    mesh = unit_cube_mesh(1)
    warnings.simplefilter("ignore", DeprecationWarning)
    if torch.cuda.is_available():
        assert DynamicLoadBalancer(4).balance(w, coords=xyz).parts.is_cuda
        assert ServeEngine(init_model(cfg), cfg).device.type == "cuda"
        assert peak_init(mesh, ParabolicProblem()).is_cuda
        return
    model = init_model(cfg, device="cpu")
    calls = [lambda: DynamicLoadBalancer(4).balance(w, coords=xyz),
             lambda: ServeEngine(model, cfg),
             lambda: solve_helmholtz_adaptive(mesh, max_steps=1),
             lambda: solve_parabolic_adaptive(mesh, n_steps=1),
             lambda: peak_init(mesh, ParabolicProblem())]
    for name in ("quickstart", "moe_balance", "train_lm"):
        calls.append(lambda name=name: W.load_example(name).main(
            ["--ckpt", str(tmp_path / "ck")] if name == "train_lm" else []))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for name in ("parallel_fem", "serve_continuous"):
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            W.load_example(name).main([])
    assert not (tmp_path / "ck").exists()
    assert DynamicLoadBalancer(4, device="cpu").balance(
        w, coords=xyz).parts.device.type == "cpu"
    assert ServeEngine(model, cfg, device="cpu").device.type == "cpu"
    assert peak_init(mesh, ParabolicProblem(), device="cpu").device.type \
        == "cpu"


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


def test_data_parallel_training_stands_alone_and_defaults_to_cuda(tmp_path):
    """The sharding rules and the mesh are among the files checked above;
    ``--mesh Dx1`` trains D ranks on the card unless asked for the CPU,
    and a mesh whose model axis does not split a leaf the rules put there
    (recurrentgemma-2b's RG-LRU width at M = 3) raises before any rank
    starts."""
    from repro_torch.launch import train as launch
    assert {"sharding.py", "mesh.py"} <= {p.name for p in PORT_FILES}
    argv = ["--arch", "llama3_8b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "64", "--ckpt", str(tmp_path / "ck")]
    with pytest.raises(ValueError, match="rglru"):
        launch.main(["--arch", "recurrentgemma_2b", "--mesh", "1x3",
                     "--ckpt", str(tmp_path / "ck")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.main(argv + ["--mesh", "2x1"])
    ranks = launch.main(argv + ["--mesh", "2x1", "--device", "cpu"])
    keys = ("step", "loss", "gnorm", "lr", "reduce_bytes", "gather_bytes")
    assert len(ranks) == 2
    assert [[{k: r[k] for k in keys} for r in h] for h in ranks[1:]] == [
        [{k: r[k] for k in keys} for r in ranks[0]]]
    assert [r["step"] for r in ranks[0]] == [0, 1]
    assert all(r["reduce_bytes"] > 0 and r["gather_bytes"] > 0
               for r in ranks[0])


def test_telemetry_smoke_stands_alone_and_defaults_to_cuda(tmp_path):
    """The exporters and the smoke are among the files checked above; the
    smoke's ranks go on the card unless ``--device cpu`` asks for CPU
    processes, and without a card the default raises (no fallback)."""
    from repro_torch.telemetry import smoke
    assert {"export.py", "smoke.py", "graph_greedy.py"} <= {
        p.name for p in PORT_FILES}
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke.main(["--out", str(tmp_path / "t")])
    assert not (tmp_path / "t").exists()


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
