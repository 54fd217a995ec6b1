"""Installed-package consumption of the port: the twin of
``tests/test_packaging.py``. Installs the port's native tree
(``spfft_tpu_torch/native/CMakeLists.txt``) into a scratch prefix, builds the
consumer project in ``spfft_tpu_torch/native/tests/consumer`` against it via
``find_package(SpFFTTPUTorch)``, runs the linked binary, validates the
installed pkg-config file, and installs the Python package with pip and
runs it from a neutral directory (reference: cmake/SpFFTConfig.cmake,
cmake/SpFFT.pc.in)."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
NATIVE = ROOT / "spfft_tpu_torch" / "native"

pytestmark = pytest.mark.skipif(
    shutil.which("cmake") is None or shutil.which("g++") is None,
    reason="native toolchain not available",
)


def _run(cmd, **kw):
    return subprocess.run(cmd, check=True, capture_output=True, text=True, **kw)


@pytest.fixture(scope="module")
def installed_prefix(tmp_path_factory):
    # scratch build dir: must NOT touch the checkout's build/ cache
    build = tmp_path_factory.mktemp("spfft_tpu_torch_pkg_build")
    prefix = tmp_path_factory.mktemp("spfft_tpu_torch_prefix")
    _run(["cmake", "-S", str(NATIVE), "-B", str(build), "-DCMAKE_BUILD_TYPE=Release",
          "-DSPFFT_TPU_TORCH_BUILD_TESTS=OFF", f"-DPython3_EXECUTABLE={sys.executable}",
          f"-DCMAKE_INSTALL_PREFIX={prefix}"])
    _run(["cmake", "--build", str(build)])
    _run(["cmake", "--install", str(build)])
    return prefix


def _libdir(prefix: Path) -> Path:
    # GNUInstallDirs may resolve to lib or lib64 depending on the platform
    for name in ("lib", "lib64"):
        if (prefix / name / "pkgconfig" / "spfft_tpu_torch.pc").exists():
            return prefix / name
    raise AssertionError(f"no installed libdir with spfft_tpu_torch.pc under {prefix}")


def test_consumer_cmake_build_against_installed_tree(installed_prefix, tmp_path):
    build = tmp_path / "consumer-build"
    _run(["cmake", "-S", str(NATIVE / "tests" / "consumer"), "-B", str(build),
          f"-DCMAKE_PREFIX_PATH={installed_prefix}"])
    _run(["cmake", "--build", str(build)])
    libdir = str(_libdir(installed_prefix))
    inherited = os.environ.get("LD_LIBRARY_PATH", "")
    out = _run([str(build / "consumer")],
               # extend, don't replace: libpython (a private dependency of the
               # library) may only resolve through the inherited loader path
               env={**os.environ,
                    "LD_LIBRARY_PATH": f"{libdir}:{inherited}" if inherited else libdir})
    assert "consumer link OK" in out.stdout


def _cmake_project_version() -> str:
    m = re.search(r"VERSION\s+(\d+\.\d+\.\d+)", (NATIVE / "CMakeLists.txt").read_text())
    assert m, "project VERSION missing in spfft_tpu_torch/native/CMakeLists.txt"
    return m.group(1)


def test_pkgconfig_file_installed_and_valid(installed_prefix):
    pc = _libdir(installed_prefix) / "pkgconfig" / "spfft_tpu_torch.pc"
    assert pc.exists()
    text = pc.read_text()
    assert "-lspfft_tpu_torch" in text
    assert f"Version: {_cmake_project_version()}" in text
    if shutil.which("pkg-config"):
        env = {**os.environ, "PKG_CONFIG_PATH": str(pc.parent)}
        cflags = _run(["pkg-config", "--cflags", "spfft_tpu_torch"], env=env).stdout
        assert "include" in cflags
        libs = _run(["pkg-config", "--libs", "spfft_tpu_torch"], env=env).stdout
        assert "-lspfft_tpu_torch" in libs


def test_version_macros_match_cmake_project():
    header = (NATIVE / "include" / "spfft" / "version.h").read_text()
    version = _cmake_project_version()
    major, minor, patch = version.split(".")
    assert f"SPFFT_TPU_VERSION_MAJOR {major}" in header
    assert f"SPFFT_TPU_VERSION_MINOR {minor}" in header
    assert f"SPFFT_TPU_VERSION_PATCH {patch}" in header
    assert f'"{version}"' in header
    # the Python package carries the same version
    import spfft_tpu_torch

    assert spfft_tpu_torch.__version__ == version
    # ... and so does the pip metadata
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert f'version = "{version}"' in pyproject


@pytest.fixture(scope="module")
def pip_target(tmp_path_factory):
    """`pip install .` of the repository into a scratch target (run with
    --no-deps/--no-build-isolation: the environment is zero-egress and torch
    is already present). It installs a copy of the project's files, so that
    its in-tree build never meets another test's install of the checkout."""
    source = tmp_path_factory.mktemp("spfft_tpu_torch_source")
    for name in ("pyproject.toml", "README.md", "LICENSE"):
        shutil.copy2(ROOT / name, source / name)
    for name in ("spfft_tpu", "spfft_tpu_torch"):
        shutil.copytree(ROOT / name, source / name,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    target = tmp_path_factory.mktemp("spfft_tpu_torch_site")
    _run([sys.executable, "-m", "pip", "install", "--no-build-isolation", "--no-deps",
          "--quiet", f"--target={target}", str(source)])
    return target


def _installed_python(target, home, code):
    return _run([sys.executable, "-c", code], cwd=str(home),
                env={**os.environ, "PYTHONPATH": str(target), "HOME": str(home),
                     "JAX_PLATFORMS": "cpu"})


def test_pip_install_and_import(pip_target, tmp_path):
    """The installed copy imports from a neutral cwd and runs a 4^3
    transform on the CPU; the file it imports is the installed one."""
    assert (pip_target / "spfft_tpu_torch" / "__init__.py").exists()
    assert (pip_target / "spfft_tpu_torch" / "native" / "CMakeLists.txt").exists()
    out = _installed_python(
        pip_target, tmp_path,
        "import spfft_tpu_torch as tp, numpy as np; "
        "t = tp.Transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 4, 4, 4,"
        "    indices=np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing='ij'), -1)"
        "    .reshape(-1, 3), dtype=np.float64); "
        "s = t.backward(np.ones(64, dtype=np.complex128)); "
        "print(tp.__file__); print('ok', tuple(s.shape), s.device)")
    assert str(pip_target) in out.stdout
    assert "ok (4, 4, 4) cpu" in out.stdout


def test_installed_copy_builds_outside_site_packages(pip_target, tmp_path):
    """An installed copy builds its kernels and its native library in the
    user's cache, not beside site-packages (which it may not write)."""
    out = _installed_python(pip_target, tmp_path,
                            "from spfft_tpu_torch import _build; print(_build.BUILD_DIR)")
    build_dir = Path(out.stdout.strip())
    assert build_dir == tmp_path / ".cache" / "spfft_tpu_torch"
    assert pip_target not in build_dir.parents
