"""The port's Python examples (spfft_tpu_torch/examples/*.py) against the JAX
package's (examples/*.py).

Each example runs as a subprocess with ``--device cpu`` beside the JAX
example (JAX_PLATFORMS=cpu): both float32 by default, the same grids and
values, the same prints where the numbers are the same computation
(``example.py`` line for line; the wire bytes of ``example_distributed.py``
exactly; ``poisson.py``'s basis and potential lines) and the final ``OK``.
In float64 in this process, ``poisson.py``'s spectral residual equals the
JAX example's to 1e-12. Without ``--device cpu`` and without a card each
example raises ``GPUNoDeviceError``.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spfft_tpu_torch as tp

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("example", "example_distributed", "poisson")


def run(path, *argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    env.pop("XLA_FLAGS", None)
    result = subprocess.run([sys.executable, str(path), *argv], capture_output=True, text=True,
                            timeout=300, env=env)
    assert result.returncode == 0, result.stderr[-2000:]
    return result.stdout.splitlines()


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def printed():
    """Each example's stdout lines: (JAX's, the port's)."""
    return {name: (run(ROOT / "examples" / f"{name}.py"),
                   run(ROOT / "spfft_tpu_torch" / "examples" / f"{name}.py", "--device", "cpu"))
            for name in EXAMPLES}


def test_example_prints_the_jax_examples_lines(printed):
    want, got = printed["example"]
    assert got == want
    err = float(got[-1].split(":")[1])
    assert 0 < err < 1e-5  # the float32 round trip


def test_example_distributed_wire_bytes_and_round_trips(printed):
    want, got = printed["example_distributed"]
    row = re.compile(r"^(\w+)\s+roundtrip (\S+)\s+wire\s+([\d,]+) B\s+rounds (\d+)$")
    jrows = [row.match(line).groups() for line in want[:3]]
    prows = [row.match(line).groups() for line in got[:3]]
    assert [r[0] for r in prows] == [r[0] for r in jrows] == [
        "BUFFERED", "COMPACT_BUFFERED", "UNBUFFERED"]
    assert [r[2] for r in prows] == [r[2] for r in jrows]  # wire bytes, exactly
    assert all(float(r[1]) < 1e-4 for r in prows)  # the example's own float32 bar
    assert all(r[3] == "1" for r in prows)  # one all_to_all_single a direction
    assert got[3] == want[3] == "space domain shape: (16, 16, 16)"


def test_poisson_prints_the_basis_potential_and_ok(printed):
    want, got = printed["poisson"]
    assert got[:2] == want[:2]
    assert got[-1] == want[-1] == "OK"
    assert float(got[2].split(":")[1]) < 1e-5


class _RecordingNumpy:
    """numpy, with each ``abs`` result kept: the JAX example computes its
    residual as ``abs(a).max() / abs(b).max()`` and prints it rounded."""

    def __init__(self):
        self.abs_results = []

    def __getattr__(self, name):
        return getattr(np, name)

    def abs(self, x):
        out = np.abs(x)
        self.abs_results.append(out)
        return out


def test_poisson_residual_equals_the_jax_examples_in_float64(capsys):
    """In this process (x64 on, so the JAX example runs float64) the port's
    float64 residual equals the JAX example's to 1e-12."""
    jax_poisson = load(ROOT / "examples" / "poisson.py", "jax_poisson_example")
    rec = _RecordingNumpy()
    jax_poisson.np = rec
    jax_poisson.main()
    want = float(rec.abs_results[-2].max() / rec.abs_results[-1].max())
    port = load(ROOT / "spfft_tpu_torch" / "examples" / "poisson.py", "port_poisson_example")
    got = port.main(["--device", "cpu", "--dtype", "float64"])
    lines = capsys.readouterr().out.splitlines()
    assert abs(got["residual"] - want) <= 1e-12
    assert got["residual"] < 1e-12
    assert lines.count("OK") == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
@pytest.mark.parametrize("name", EXAMPLES)
def test_without_a_card_each_example_raises(name):
    module = load(ROOT / "spfft_tpu_torch" / "examples" / f"{name}.py", f"port_{name}_example")
    with pytest.raises(tp.GPUNoDeviceError):
        module.main([])
