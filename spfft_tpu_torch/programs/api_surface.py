"""Parsers of the port's native API surface (its C headers and Fortran module).

The port's copy of the JAX package's ``programs/api_surface.py``, pointed at
``spfft_tpu_torch/native/include/spfft/``: the API reference generator
(``gen_api_docs.py``) and the surface tests parse through these helpers, so
that both see the same prototype set. Stdlib only.

    python spfft_tpu_torch/programs/api_surface.py   # port vs the JAX package's headers
"""
from __future__ import annotations

import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
INCLUDE = ROOT / "spfft_tpu_torch" / "native" / "include" / "spfft"
F90_PATH = INCLUDE / "spfft.f90"
C_HEADER_NAMES = ("grid.h", "transform.h", "multi_transform.h")
C_HEADER_PATHS = tuple(INCLUDE / name for name in C_HEADER_NAMES)
C_CONSTANT_HEADER_NAMES = ("errors.h", "types.h")
C_CONSTANT_HEADER_PATHS = tuple(INCLUDE / name for name in C_CONSTANT_HEADER_NAMES)
# the JAX package's headers, which the port's declare name for name
JAX_INCLUDE = ROOT / "native" / "include" / "spfft"


def join_continuations(text: str) -> str:
    """Fortran free-form: a trailing '&' continues the statement."""
    return re.sub(r"&\s*\n\s*", " ", text)


def strip_c_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.DOTALL)
    text = re.sub(r"//[^\n]*", " ", text)
    return text


def fortran_functions(path: Path = F90_PATH) -> dict:
    """{lowercased name: arg count} for every bind(C) function interface."""
    text = join_continuations(path.read_text())
    out = {}
    for m in re.finditer(
        r"function\s+(spfft_\w+)\s*\(([^)]*)\)\s*bind\s*\(\s*C", text, re.IGNORECASE
    ):
        args = [a.strip() for a in m.group(2).split(",") if a.strip()]
        out[m.group(1).lower()] = len(args)
    return out


def c_prototypes(path: Path) -> list:
    """[(name, [arg, ...]), ...] for every SpfftError-returning prototype,
    in declaration order."""
    joined = re.sub(r"\s+", " ", strip_c_comments(path.read_text()))
    return [
        (m.group(1), [a.strip() for a in m.group(2).split(",") if a.strip()])
        for m in re.finditer(r"SpfftError\s+(spfft_\w+)\s*\(([^)]*)\)\s*;", joined)
    ]


def c_functions(paths=C_HEADER_PATHS) -> dict:
    """{lowercased name: arg count} across the given headers."""
    out = {}
    for path in paths:
        for name, args in c_prototypes(path):
            out[name.lower()] = len(args)
    return out


def fortran_constants(path: Path = F90_PATH) -> dict:
    """{NAME: value} for every ``integer(c_int), parameter`` constant (one
    per statement, or a continuation list under one ``parameter ::``)."""
    text = join_continuations(path.read_text())
    out = {}
    for stmt in re.finditer(
        r"integer\s*\(\s*c_int\s*\)\s*,\s*parameter\s*::([^\n]*)",
        text,
        re.IGNORECASE,
    ):
        for m in re.finditer(r"(SPFFT_\w+)\s*=\s*(-?\d+)", stmt.group(1)):
            out[m.group(1)] = int(m.group(2))
    return out


def c_enum_constants(paths=C_CONSTANT_HEADER_PATHS) -> dict:
    """{NAME: value} for every SPFFT_* enumerator, explicit or implicit."""
    out = {}
    for path in paths:
        text = strip_c_comments(path.read_text())
        for body in re.finditer(r"\benum\s+\w+\s*\{([^}]*)\}", text):
            counter = 0
            for entry in body.group(1).split(","):
                m = re.match(r"\s*(SPFFT_[A-Z0-9_]+)\s*(?:=\s*(-?\d+))?\s*$", entry)
                if m is None:
                    continue
                if m.group(2) is not None:
                    counter = int(m.group(2))
                out[m.group(1)] = counter
                counter += 1
    return out


def surface_names(include_dir: Path) -> dict:
    """{name: arg count} across every C header (.h) in ``include_dir``."""
    out = {}
    for path in sorted(include_dir.glob("*.h")):
        for name, args in c_prototypes(path):
            out[name] = len(args)
    return out


def surface_mismatches(other: Path = JAX_INCLUDE) -> list:
    """``name/arity`` of the C API names whose arity differs between the
    port's headers and ``other``'s, or that only one side declares; []
    when they agree (or ``other`` is absent)."""
    if not other.is_dir():
        return []
    theirs, ours = surface_names(other), surface_names(INCLUDE)
    return sorted(
        f"{name}/{theirs.get(name, ours.get(name))}"
        for name in set(theirs) | set(ours)
        if theirs.get(name) != ours.get(name)
    )


if __name__ == "__main__":
    import sys

    missing = surface_mismatches()
    if missing:
        print("C API names that differ from the JAX package's headers (name/arity):")
        for entry in missing:
            print(" ", entry)
        sys.exit(1)
    print(f"C API surface complete: {len(surface_names(INCLUDE))} names, the same "
          "names and arities as the JAX package's headers")
