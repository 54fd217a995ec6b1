"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``<name>-<hash>.so`` in :data:`BUILD_DIR`:
``build/spfft_tpu_torch/`` at the root of a checkout (the directory that
holds ``pyproject.toml`` beside the package), or, for an installed copy
(``pip install .``), ``~/.cache/spfft_tpu_torch/``, a directory the user can
write where site-packages may not be. ``<hash>`` is the content hash of the source
and of every ``csrc/`` header it includes: a changed source or header builds
anew, an unchanged one loads the library already there. Beside the library,
``<name>-<hash>.log`` keeps what ``nvcc`` printed (ptxas's registers, shared
memory and spills per kernel). The sources have a plain C interface and
include no PyTorch or CUTLASS header, so one ``nvcc`` takes seconds.
:func:`build_all` starts one ``nvcc`` per source, all at once.

:func:`build_native` builds the C/C++/Fortran API of ``native/`` with the
host compilers (``g++``, the C compiler, ``gfortran`` where there is one):
``libspfft_tpu_torch.so``, which embeds CPython through the flags of the
running interpreter (``sysconfig``), and the programs that link it (the C
and C++ API tests, the benchmark, the examples), into
``build/spfft_tpu_torch/native/<hash>/``, keyed by the content of every
source and header and the interpreter's build, like the kernels. It is
what the tests and ``chip_smoke.py`` build with. The installable route is the
CMake tree ``native/CMakeLists.txt`` (``cmake --install``, then
``find_package(SpFFTTPUTorch)`` or ``pkg-config spfft_tpu_torch``), which
builds the same sources with the same flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

from .errors import GPUSupportError

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    """The checkout's ``build/spfft_tpu_torch/``, else the user's cache."""
    root = Path(__file__).resolve().parent.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "spfft_tpu_torch"
    return Path.home() / ".cache" / "spfft_tpu_torch"


BUILD_DIR = _build_dir()
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


# ---- the native C/C++/Fortran API (native/) ------------------------------------------

NATIVE = Path(__file__).resolve().parent / "native"
EXAMPLES = Path(__file__).resolve().parent / "examples"
NATIVE_LIBRARY = "libspfft_tpu_torch.so"
_LIBRARY_SOURCES = ("src/bridge.cpp", "src/spfft.cpp", "src/capi_c.cpp")
# executable -> source; each links libspfft_tpu_torch.so
NATIVE_PROGRAMS = {
    "run_native_tests": NATIVE / "tests" / "test_api.c",
    "run_native_tests_cpp": NATIVE / "tests" / "test_api_cpp.cpp",
    "benchmark": NATIVE / "programs" / "benchmark.c",
    "example": EXAMPLES / "example.c",
    "example_cpp": EXAMPLES / "example.cpp",
    "example_distributed": EXAMPLES / "example_distributed.c",
}
FORTRAN_EXAMPLE = "example_f90"  # built only where gfortran exists


def _python_flags() -> tuple[list[str], list[str], bool]:
    """The running interpreter's include flags, its link flags, and whether
    libpython is a shared library."""
    cfg = sysconfig.get_config_var
    include = ["-I" + sysconfig.get_paths()["include"]]
    shared = bool(cfg("Py_ENABLE_SHARED"))
    libdir = cfg("LIBDIR") if shared else (cfg("LIBPL") or cfg("LIBDIR"))
    link = [f"-L{libdir}", f"-lpython{cfg('LDVERSION') or cfg('VERSION')}"]
    if shared:
        link.append(f"-Wl,-rpath,{libdir}")
    return include, link + (cfg("LIBS") or "").split() + (cfg("SYSLIBS") or "").split(), shared


def _c_compiler() -> list[str]:
    found = shutil.which("gcc") or shutil.which("cc")
    return [found] if found else ["g++", "-x", "c"]


def native_sources() -> list[Path]:
    """Every file the native build reads: headers, sources, programs, examples."""
    return sorted(p for p in [*NATIVE.rglob("*"), *EXAMPLES.iterdir()] if p.is_file()
                  and p.suffix in (".h", ".hpp", ".c", ".cpp", ".f90"))


def native_dir() -> Path:
    """``build/spfft_tpu_torch/native/<hash>``: the hash of the sources and of
    the interpreter the library embeds."""
    digest = hashlib.sha256(repr((sys.version, _python_flags())).encode())
    for path in native_sources():
        digest.update(str(path.relative_to(NATIVE.parent)).encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / "native" / digest.hexdigest()[:16]


def _run_all(commands: dict, cwd: Path) -> None:
    """Run the named compiler commands at once in ``cwd``; raise with the
    output of those that fail."""
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, cwd=cwd) for name, cmd in commands.items()}
    failed = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: {' '.join(commands[name])}\n{out}")
    if failed:
        raise GPUSupportError("the native build failed:\n" + "\n".join(failed))


def build_native() -> Path:
    """Build ``libspfft_tpu_torch.so`` and :data:`NATIVE_PROGRAMS` (and the
    Fortran example where ``gfortran`` exists) unless current; returns the
    directory. The library and the programs' objects compile in parallel,
    then the programs link; the directory appears whole (a rename), so
    concurrent builds do not see each other's parts."""
    target = native_dir()
    if target.exists():
        return target
    if shutil.which("g++") is None:
        raise GPUSupportError("g++ not found: the native API needs a C++ compiler")
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    include, python_link, shared = _python_flags()
    headers = ["-I" + str(NATIVE / "include")]
    lib = tmp / NATIVE_LIBRARY
    first = {"library": ["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-o", str(lib),
                         *headers, "-I" + str(NATIVE / "src"), *include,
                         *(str(NATIVE / s) for s in _LIBRARY_SOURCES),
                         *(python_link if shared else [])]}
    for name, src in NATIVE_PROGRAMS.items():
        cc = ["g++", "-std=c++17"] if src.suffix == ".cpp" else _c_compiler()
        first[name] = [*cc, "-O2", "-c", "-o", str(tmp / f"{name}.o"), *headers, str(src)]
    fortran = shutil.which("gfortran")
    if fortran:
        first[FORTRAN_EXAMPLE] = [fortran, "-c", "-J", str(tmp),
                                  str(NATIVE / "include" / "spfft" / "spfft.f90"),
                                  str(EXAMPLES / "example.f90")]
    _run_all(first, tmp)
    # a static libpython: the programs carry the interpreter and export its
    # symbols, which torch's extension modules resolve against
    embed = [] if shared else ["-rdynamic", "-Wl,--whole-archive", *python_link[:2],
                               "-Wl,--no-whole-archive", *python_link[2:]]
    link = [f"-L{tmp}", "-lspfft_tpu_torch", f"-Wl,-rpath,{target}", *embed, "-lm"]
    second = {name: ["g++" if src.suffix == ".cpp" else _c_compiler()[0], "-o",
                     str(tmp / name), str(tmp / f"{name}.o"), *link]
              for name, src in NATIVE_PROGRAMS.items()}
    if fortran:
        second[FORTRAN_EXAMPLE] = [fortran, "-o", str(tmp / FORTRAN_EXAMPLE),
                                   str(tmp / "spfft.o"), str(tmp / "example.o"), *link]
    _run_all(second, tmp)
    try:
        os.replace(tmp, target)
    except OSError:  # a concurrent build got there first
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def native_env(env=None) -> dict:
    """The environment of a native program: its embedded interpreter finds
    this checkout and the running interpreter's packages (torch) on
    ``PYTHONPATH``."""
    import site

    env = dict(os.environ if env is None else env)
    paths = [str(NATIVE.parent.parent), *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def load_native() -> ctypes.CDLL:
    """``libspfft_tpu_torch.so`` loaded into this process (built on first
    use): its bridge uses this interpreter."""
    lib = _libraries.get(NATIVE_LIBRARY)
    if lib is None:
        lib = _libraries[NATIVE_LIBRARY] = ctypes.CDLL(str(build_native() / NATIVE_LIBRARY))
    return lib
