"""What ``BENCHMARK.json`` names, found by name in the harness's folders.

A cell (an entry of ``workloads``) names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, ``traffic/<name>.json``. Every
metric, end-to-end or per-layer, is read by ``metrics/<name>.py``, whose
``read(ctx)`` returns a number or None where it finds nothing to read.
Adding a configuration, a mix, a cell or a metric adds files and entries
and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)  # the entries of BENCHMARK.json
    per_layer: list = field(default_factory=list)

    def metrics(self, trace: bool) -> list:
        """The metrics a run reports: the end-to-end ones untraced, the
        per-layer ones traced."""
        return self.per_layer if trace else self.end_to_end


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict | None = None, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics, from
    the checkout ``root`` and the harness folder ``here``."""
    bench = load_benchmark(root) if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, config=json.loads((root / conf["file"]).read_text()),
                traffic=traffic(w["traffic"], here), chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def kernel_families(here: Path = HERE) -> dict:
    """Kernel family -> the name patterns of its kernels (``kernels.json``)."""
    return json.loads((here / "kernels.json").read_text())["families"]


_readers: dict = {}


def reader(name: str, here: Path = HERE):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    if path not in _readers:
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _readers[path] = module.read
    return _readers[path]
