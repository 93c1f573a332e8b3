"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc -c`` (all started together),
then linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``build/kernels/`` at the repository root,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once.  Nothing is built when this module is
imported: the first wrapper call on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sfc_keys.cu", "ksection_hist.cu", "fem_matvec.cu",
           "prefix_scan.cu", "flash_attention.cu", "flash_attention_tc.cu",
           "serve_prefill.cu")
HEADERS = ("attention_tile.cuh", "attention_tc.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels if no library for the current sources exists.

    The compiler's output (``-Xptxas=-v``: registers, shared memory and
    spills per kernel) goes to ``build/kernels/build.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(exist_ok=True)
    cc = nvcc()
    objs: List[Path] = []
    procs = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [cc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for name, proc in zip(SOURCES, procs):
        text, _ = proc.communicate()
        logs.append(f"== {name} (exit {proc.returncode})\n{text}")
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    failed = [name for name, proc in zip(SOURCES, procs) if proc.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = work / out.name
    link = subprocess.run(
        [cc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.repro_sfc_keys.argtypes = [p, p, ll, i, i, p]
    lib.repro_sfc_keys.restype = i
    lib.repro_ksection_hist.argtypes = [p, p, ll, p, ll, p, i, p, p]
    lib.repro_ksection_hist.restype = i
    lib.repro_fem_matvec.argtypes = [p, p, p, p, p, p, p, ll, p, ll, p, p, p,
                                     ll, p]
    lib.repro_fem_matvec.restype = i
    lib.repro_fem_matvec_chunk.argtypes = []
    lib.repro_fem_matvec_chunk.restype = i
    lib.repro_prefix_scan.argtypes = [p, ll, p, p, ctypes.c_uint, p]
    lib.repro_prefix_scan.restype = i
    lib.repro_prefix_scan_tile.argtypes = []
    lib.repro_prefix_scan_tile.restype = i
    lib.repro_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, f, i,
                                          i, p]
    lib.repro_flash_attention.restype = i
    lib.repro_flash_attention_tc.argtypes = [p, p, p, p, i, i, i, i, i, f,
                                             i, i, p]
    lib.repro_flash_attention_tc.restype = i
    lib.repro_packed_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, f,
                                           f, p]
    lib.repro_packed_attention.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(build())))
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err:
        text = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({text})")
