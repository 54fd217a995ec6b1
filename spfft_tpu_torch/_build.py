"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/spfft_tpu_torch/<name>-<hash>.so`` at
the root of the checkout, where ``<hash>`` is the content hash of the source
and of every ``csrc/`` header it includes: a changed source or header builds
anew, an unchanged one loads the library already there. Beside the library,
``<name>-<hash>.log`` keeps what ``nvcc`` printed (ptxas's registers, shared
memory and spills per kernel). The sources have a plain C interface and
include no PyTorch or CUTLASS header, so one ``nvcc`` takes seconds.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from .errors import GPUSupportError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "spfft_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise GPUSupportError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, transitively."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (CSRC / inc).exists():
                todo.append(CSRC / inc)
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``csrc/<name>.cu`` (ptxas's report)."""
    return _target(name).with_suffix(".log").read_text()


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
    target.with_suffix(".log").write_text(out)
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
        try:
            lib = ctypes.CDLL(str(_target(name)))
        except OSError as e:
            raise GPUSupportError(f"cannot load the library of csrc/{name}.cu: {e}") from e
        _libraries[name] = lib
    return lib
