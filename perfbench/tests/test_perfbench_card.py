"""On the card: a short run of every cell is correct, and the control (the
port at ``precision="high"``, bf16x3) comes out not correct through the
harness's own window and check at the cell's own size on three seeds.
Skips where there is no CUDA device, or fewer than the cell's cards.

    python -m pytest perfbench/tests/test_perfbench_card.py -q   # on the card, about 6 minutes
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
CELLS = [w["name"] for w in WORKLOADS]
CHIPS = {w["name"]: w["chips"] for w in WORKLOADS}


def card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < CHIPS[cell]:
        pytest.skip(f"{cell} needs {CHIPS[cell]} CUDA devices")


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(name):
    card(name)
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                           "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = last_json(proc.stdout)
    assert out["correct"] and out["device"]["platform"] == "gpu", out


@pytest.mark.card
@pytest.mark.parametrize("name", sorted({n.split(".")[0] for n in CELLS}))
def test_the_control_fails_at_the_cells_size(name):
    cell = next(n for n in CELLS if n.startswith(name + "."))
    card(cell)
    proc = subprocess.run([sys.executable, "perfbench/calibrate.py", "--workload", cell,
                           "--control-seeds", "101", "2147483749", "4000000003"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 3 and all(r["side"] == "control" and r["precision"] == "high"
                                  and not r["correct"] for r in rows), rows
