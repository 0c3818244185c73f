"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so``
at the repository root (listed in ``.gitignore``), keyed on a hash of the
source, the headers it includes (``DEPS``) and the flags, then loaded with
``ctypes``. Nothing here runs at import: a machine without ``nvcc``
imports the kernel modules cleanly and fails only when a CUDA tensor needs
a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["load", "build_all", "SOURCES", "DEPS", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "ssd_scan", "rglru_scan")
#: the headers under ``csrc/`` each source includes: a change rebuilds it
DEPS = {"flash_attention": ("attn_split.cuh", "mma_bf16.cuh"),
        "flash_attention_bwd": ("attn_split.cuh", "mma_bf16.cuh"),
        "decode_attention": ("attn_split.cuh",)}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in DEPS.get(name, ()):
        h.update((CSRC / dep).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library is built; returns the
    running process (None when built) and the library path."""
    src, lib = _target(name)
    if lib.exists():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *FLAGS, "-o", str(_tmp(lib)), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _tmp(lib: Path) -> Path:
    return lib.with_suffix(f".{os.getpid()}.tmp")


def _finish(name: str, proc, lib: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    lib.with_suffix(".log").write_text(out)          # -Xptxas -v report
    os.replace(_tmp(lib), lib)                       # atomic publish


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source at once (one nvcc each, all started together)."""
    started = {n: _start(n) for n in names}
    for n, (proc, lib) in started.items():
        _finish(n, proc, lib)
    return {n: lib for n, (_, lib) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        proc, path = _start(name)
        _finish(name, proc, path)
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
