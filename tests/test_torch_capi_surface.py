"""The port's C/Fortran surface: ``spfft.f90`` against ``capi_c.cpp`` and the headers.

The port keeps its own copies of the reference surface under
``spfft_tpu_torch/native/include/spfft/``. Checked here, with the parsers of
``programs/api_surface.py`` pointed at the port's files, in both directions:
every Fortran ``bind(C)`` interface names a C function that the port's
``capi_c.cpp`` defines, with the same arity, and every such function has a
binding (the pointer-returning accessors and the MPI stubs' Fortran
communicator forms excepted); the Fortran and C constants agree; the port's headers declare
exactly the C names and arities of ``native/include/spfft/``, in the same
files; and the headers and ``capi_c.cpp`` agree.
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "programs"))

from api_surface import (  # noqa: E402
    C_CONSTANT_HEADER_NAMES,
    C_HEADER_NAMES,
    c_enum_constants,
    c_functions,
    fortran_constants,
    fortran_functions,
    strip_c_comments,
    surface_names,
)

PORT = ROOT / "spfft_tpu_torch" / "native"
INCLUDE = PORT / "include" / "spfft"
REFERENCE = ROOT / "native" / "include" / "spfft"
F90 = INCLUDE / "spfft.f90"
CAPI_C = PORT / "src" / "capi_c.cpp"


def defined_functions(path: Path = CAPI_C) -> dict:
    """{lowercased name: arg count} of every ``SpfftError spfft_*(...) {``
    definition, those that a getter macro (``#define M(FN, ...) SpfftError
    FN(...)``) writes included."""
    joined = re.sub(r"\s+", " ", strip_c_comments(path.read_text()).replace("\\\n", " "))
    arity = lambda args: len([a for a in args.split(",") if a.strip()])
    out = {m.group(1).lower(): arity(m.group(2))
           for m in re.finditer(r"SpfftError\s+(spfft_\w+)\s*\(([^)]*)\)\s*\{", joined)}
    for m in re.finditer(r"#define (\w+)\(FN,[^)]*\) SpfftError FN\(([^)]*)\)", joined):
        for call in re.finditer(rf"\b{m.group(1)}\(\s*(spfft_\w+)", joined):
            out[call.group(1).lower()] = arity(m.group(2))
    return out


def header_functions() -> dict:
    return c_functions(tuple(INCLUDE / name for name in C_HEADER_NAMES))


def test_every_fortran_binding_names_a_defined_c_function_with_same_arity():
    fortran, defined = fortran_functions(F90), defined_functions()
    assert fortran and defined
    missing = sorted(set(fortran) - set(defined))
    assert not missing, f"Fortran bindings without a C function: {missing}"
    mismatched = {n: (fortran[n], defined[n]) for n in fortran if fortran[n] != defined[n]}
    assert not mismatched


def test_every_defined_c_function_has_a_fortran_binding():
    fortran, defined = fortran_functions(F90), defined_functions()
    # and the MPI stubs' Fortran-communicator forms, which take a Fortran
    # integer handle from C, not from a binding
    exempt = {n for n in defined
              if n.endswith(("_space_domain_data", "_ptr", "_communicator_fortran",
                             "_distributed_fortran"))}
    unbound = sorted(set(defined) - set(fortran) - exempt)
    assert not unbound, f"C API functions with no Fortran binding: {unbound}"


def test_the_headers_declare_what_capi_c_defines():
    declared, defined = header_functions(), defined_functions()
    assert declared == {n: a for n, a in defined.items() if n in declared}
    assert sorted(set(declared) - set(defined)) == []


def test_constants_match_between_fortran_and_c_both_directions():
    fortran = fortran_constants(F90)
    c = c_enum_constants(tuple(INCLUDE / name for name in C_CONSTANT_HEADER_NAMES))
    assert fortran and c
    assert sorted(set(c) - set(fortran)) == []
    assert sorted(set(fortran) - set(c)) == []
    assert {n: (fortran[n], c[n]) for n in c if fortran[n] != c[n]} == {}


def test_the_port_declares_exactly_the_reference_surface():
    assert sorted(p.name for p in INCLUDE.iterdir()) == sorted(p.name for p in REFERENCE.iterdir())
    assert surface_names(INCLUDE) == surface_names(REFERENCE)
    assert fortran_functions(F90) == fortran_functions(REFERENCE / "spfft.f90")
    assert fortran_constants(F90) == fortran_constants(REFERENCE / "spfft.f90")
    assert defined_functions() == defined_functions(ROOT / "native" / "src" / "capi_c.cpp")


def test_no_port_file_includes_a_header_of_the_jax_packages_native_tree():
    for path in [*PORT.rglob("*"), *(ROOT / "spfft_tpu_torch" / "examples").iterdir()]:
        if path.is_file() and path.suffix in (".h", ".hpp", ".c", ".cpp", ".f90", ".py"):
            text = path.read_text()
            assert "native/include" not in text.replace("spfft_tpu_torch/native/include", "")
            assert not re.search(r"^\s*(import|from)\s+(jax|spfft_tpu)\b", text, re.M), path
            assert '"spfft_tpu.capi"' not in text, path


def test_the_fortran_module_compiles_when_a_compiler_exists():
    fc = shutil.which("gfortran") or shutil.which("flang") or shutil.which("f95")
    if fc is None:
        pytest.skip("no Fortran compiler in this environment")
    result = subprocess.run([fc, "-fsyntax-only", str(F90)], capture_output=True, text=True)
    assert result.returncode == 0, result.stderr
