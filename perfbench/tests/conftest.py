"""The harness's tests: ``python -m pytest perfbench/tests -q`` from the
checkout's root. Tests marked ``card`` need a CUDA device and skip inside
the test where there is none."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips where there is none)")
