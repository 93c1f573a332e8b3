"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import Balancer, BalanceSpec
from repro_torch.fem import AdaptiveSession, AdaptSpec

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
            "repro_torch.kernels, repro_torch.interop, repro_torch.telemetry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert Balancer(BalanceSpec(p=4)).device.type == "cuda"
        assert AdaptiveSession(AdaptSpec()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Balancer(BalanceSpec(p=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaptiveSession(AdaptSpec())
    assert Balancer(BalanceSpec(p=4), device="cpu").device.type == "cpu"
    assert AdaptiveSession(AdaptSpec(), device="cpu").device.type == "cpu"


def test_sharded_session_names_the_roadmap_item():
    spec = AdaptSpec(backend="sharded",
                     balance=BalanceSpec(p=4, backend="sharded"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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
