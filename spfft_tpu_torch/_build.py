"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/spfft_tpu_torch/<name>-<hash>.so`` at
the root of the checkout, where ``<hash>`` is the source's content hash: a
changed source builds anew, an unchanged one loads the library already there.
The sources have a plain C interface and include no PyTorch header, so one
``nvcc`` takes seconds. :func:`build_all` starts one ``nvcc`` per source, all
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from .errors import GPUSupportError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "spfft_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise GPUSupportError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for ``name`` unless its library is current; None if it is."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    target, tmp, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise GPUSupportError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing


def build_all(names) -> None:
    """Build every named source that is not current, one nvcc each, in parallel."""
    started = {name: _start(name) for name in names}
    for name, s in started.items():
        if s is not None:
            _finish(name, s)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libraries.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _libraries[name] = lib
    return lib
