"""Project lint of the port — a thin shim over checkers SA001-SA009.

The port's copy of the JAX package's ``programs/lint.py``: it runs exactly
the import-hygiene and vocabulary checkers of ``spfft_tpu_torch.analysis``
through the same gate as ``analyze.py`` (baseline applied, ``# noqa:
<CODE>`` suppression honored) and exits 3 on any new finding. Run it by its
path, as ``analyze.py``:

    python spfft_tpu_torch/programs/lint.py

The full gate — including the deep checkers (typed errors, lock order,
donation safety, capture purity, knob registry, ...) — is
``spfft_tpu_torch/programs/analyze.py``.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def _analyze():
    """``analyze.py`` beside this file, loaded by its path (no package
    import: ``spfft_tpu_torch/__init__`` would pull torch)."""
    name = "spfft_tpu_torch_analyze_program"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(__file__).resolve().parent / "analyze.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for code in (f"SA00{i}" for i in range(1, 10)):
        argv += ["--only", code]
    return _analyze().main(argv)


if __name__ == "__main__":
    sys.exit(main())
