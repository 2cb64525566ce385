"""Build and load the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` compiles with plain ``nvcc`` into a
shared library with a C interface (no PyTorch headers, so a build takes
seconds), which is loaded with ``ctypes``. Libraries are cached under
``build/kernels/`` at the repository root (override with
``REPRO_TORCH_BUILD_DIR``), named by a hash of the source, every header
``csrc/*.cuh`` it may include, and the flags, so an edited source or header
rebuilds and an unchanged one loads at once.

Nothing builds at import time: ``load(name)`` builds on first use, and
``build_all()`` starts one ``nvcc`` per source, all at once, and waits.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"quantize_ef": CSRC / "quantize_ef.cu",
           "paged_attention": CSRC / "paged_attention.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "ssd_chunked": CSRC / "ssd_chunked.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]  # registers, shared memory and spills per kernel

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the repository root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of repro_torch build with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every (or the named) kernel source, all nvcc processes at
    once; returns {name: compiler output} ("" for a cached library)."""
    names = list(SOURCES) if names is None else list(names)
    started = {n: _start(n) for n in names}
    logs, errors = {}, []
    for n, st in started.items():  # wait for every nvcc, then report
        try:
            logs[n] = _finish(n, st) if st is not None else ""
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
