"""The port's C library itself: ``libspfft_tpu_torch.so`` and the programs on it.

``spfft_tpu_torch._build.build_native`` builds the library (the C/C++
surface of ``spfft_tpu_torch/native/``, its bridge embedding CPython over
``spfft_tpu_torch.capi``) and the programs that link it into
``build/spfft_tpu_torch/native/<hash>/`` with ``g++`` (never ``native/build``,
which tests/test_native_api.py builds). Then, on the CPU (``SPFFT_PU_HOST``):
the twin C and C++ API tests, the C, C++ and distributed examples (the
Fortran one where ``gfortran`` exists), the benchmark twin at 16^3 with its
three bad usages exiting 2, and the library loaded into this process with
ctypes, its double-precision transforms held against ``spfft_tpu.Transform``
on the same triplets at 1e-12.
"""
import json
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import pytest

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu_torch import _build
from utils import storage

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None
    or not (Path(sysconfig.get_paths()["include"]) / "Python.h").exists(),
    reason="g++ or Python.h unavailable",
)
TIMEOUT = 600


@pytest.fixture(scope="module")
def built():
    return _build.build_native()


def run(built, name, *args, timeout=TIMEOUT):
    return subprocess.run([str(built / name), *args], env=_build.native_env(),
                          capture_output=True, text=True, timeout=timeout, cwd=built)


def test_the_build_lands_beside_the_kernels(built):
    assert built.parent == _build.BUILD_DIR / "native"
    assert (built / _build.NATIVE_LIBRARY).exists()
    for name in _build.NATIVE_PROGRAMS:
        assert (built / name).exists(), name
    # the Fortran example exactly where a Fortran compiler exists
    assert (built / _build.FORTRAN_EXAMPLE).exists() == (shutil.which("gfortran") is not None)
    assert _build.build_native() == built  # current: nothing to rebuild


@pytest.mark.parametrize("name,marker", [("run_native_tests", "ALL NATIVE TESTS PASSED"),
                                         ("run_native_tests_cpp", "ALL NATIVE C++ TESTS PASSED")])
def test_the_twin_api_tests_pass(built, name, marker):
    result = run(built, name)
    assert result.returncode == 0, result.stdout + result.stderr
    assert marker in result.stdout


@pytest.mark.parametrize("name,marker", [
    ("example", "roundtrip, first element"),
    ("example_cpp", "roundtrip, first element"),
    ("example_distributed", "distributed roundtrip max error"),
    ("example_f90", None),
])
def test_the_examples_run(built, name, marker):
    if name == _build.FORTRAN_EXAMPLE and shutil.which("gfortran") is None:
        assert not (built / name).exists()
        return
    result = run(built, name)
    assert result.returncode == 0, result.stdout + result.stderr
    assert marker is None or marker in result.stdout
    assert "Warning" not in result.stderr and "warn" not in result.stderr.lower()


def test_the_benchmark_twin(built, tmp_path):
    out = tmp_path / "bench.json"
    result = run(built, "benchmark", "-d", "16", "16", "16", "-r", "2", "-s", "0.5", "-t",
                 "r2c", "-m", "2", "-o", str(out))
    assert result.returncode == 0, result.stdout + result.stderr
    report = json.loads(out.read_text())
    assert report["parameters"]["num_transforms"] == 2
    assert report["results"]["ms_per_pair"] > 0

    result = run(built, "benchmark", "-d", "16", "16", "16", "-r", "2", "--shards", "2",
                 "-e", "unbuffered")
    assert result.returncode == 0, result.stdout + result.stderr
    assert "wire_bytes=" in result.stdout
    report = json.loads(result.stdout[result.stdout.index("{"):])
    assert report["parameters"]["exchange"] == "unbuffered"


@pytest.mark.parametrize("bad", [["-d", "16", "16"],
                                 ["-d", "16", "16", "16", "-r", "2", "-t", "R2C"],
                                 ["-d", "16", "16", "16", "-r", "2", "-e", "bufferred"]],
                         ids=["dims", "type", "exchange"])
def test_the_benchmark_refuses_bad_usage(built, bad):
    assert run(built, "benchmark", *bad, timeout=60).returncode == 2


def _values(trip, dims, r2c, seed):
    X, Y, Z = dims
    rng = np.random.default_rng(seed)
    if r2c:
        spec = np.fft.fftn(rng.standard_normal((Z, Y, X)))
        return spec[storage(trip[:, 2], Z), storage(trip[:, 1], Y), trip[:, 0]]
    return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_the_library_in_process_against_the_jax_package(built, r2c):
    from spfft_tpu_torch.native import abi

    dims = (8, 10, 9)
    X, Y, Z = dims
    trip = np.asarray(tp.create_spherical_cutoff_triplets(*dims, 0.8, hermitian_symmetry=r2c),
                      dtype=np.int32)
    vals = _values(trip, dims, r2c, 2)
    api = abi.Api()
    plan = api.transform(1, int(r2c), dims, trip, True)
    try:
        space = np.zeros(X * Y * Z * (1 if r2c else 2))
        plan.backward(np.ascontiguousarray(vals.view(np.float64)), space)
        back = np.zeros(2 * len(trip))
        plan.forward(space, back, int(tp.ScalingType.FULL))
    finally:
        plan.close()
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), *dims, indices=trip,
                              dtype=np.float64, engine="xla")
    want = np.asarray(ref.backward(vals))
    got = space.reshape(Z, Y, X) if r2c else space.view(np.complex128).reshape(Z, Y, X)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    want_back = np.asarray(ref.forward(want, spfft_tpu.ScalingType.FULL))
    got_back = back.view(np.complex128)
    assert np.abs(got_back - want_back).max() <= 1e-12 * np.abs(want_back).max()


def test_the_library_in_process_reports_error_codes(built):
    from spfft_tpu_torch.native import abi

    api = abi.Api()
    trip = np.asarray([[0, 0, 0], [0, 0, 0]], dtype=np.int32)  # a duplicate
    with pytest.raises(abi.NativeError) as e:
        api.transform(1, 0, (4, 4, 4), trip, True)
    assert e.value.code == int(tp.ErrorCode.DUPLICATE_INDICES)
