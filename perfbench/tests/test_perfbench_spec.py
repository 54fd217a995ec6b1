"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding configurations, mixes, cells and metrics by name: a new file is
picked up with no edit."""
import json
import re
import shutil
import statistics
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import spec
from spfft_tpu_torch import ExchangeType

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and (ROOT / path).is_dir()
        assert not path.endswith("_torch") and ".." not in path
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check with 24 cells fits: 2 + 14 runs a cell, 180 s of compile a cell, 1200 spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert set(body["check"]["limits"]) == {"bwd_err", "fwd_err"}


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()


def test_a_cell_over_more_chips_runs_one_slab_rank_a_chip():
    for w in BENCH["workloads"]:
        cfg = spec.cell(w["name"], BENCH).config
        if w["chips"] > 1 or "ranks" in cfg:
            assert cfg["ranks"] == w["chips"] and cfg["decomposition"] == "slab"
            assert cfg["exchange"].upper() in ExchangeType.__members__


def test_metrics():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", []):  # each cell listed reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(name):
    cell = spec.cell(name, BENCH)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == name)


def test_a_new_config_mix_cell_and_metric_are_picked_up(tmp_path):
    """A later change adds files and entries only: the harness finds them."""
    here = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (here / "configs" / "c2c-96-r05.json").write_text(json.dumps(
        {"name": "c2c-96-r05", "grid": [96, 96, 96], "transform": "c2c",
         "sphere_fraction": 0.065, "dtype": "float32",
         "precision": "highest", "bands": 8, "reduced": [],
         "check": {"sampled_spaces": 1, "limits": {"bwd_err": 1e-5, "fwd_err": 1e-5}}}))
    (here / "traffic" / "bands-batched.json").write_text(json.dumps(
        {"fence_every": 8, "profile_pairs": 64}))
    (here / "metrics" / "pairs_per_window.py").write_text(
        "def read(ctx):\n    return ctx.window['pairs']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "c2c-96-r05", "source": "https://example.org/x",
                             "file": "perfbench/configs/c2c-96-r05.json", "reduced": [],
                             "why": "new"})
    bench["workloads"].append({"name": "c2c-96-r05.bands-batched", "config": "c2c-96-r05",
                               "traffic": "bands-batched", "chips": 1, "why": "new"})
    bench["end_to_end"].append({"name": "pairs_per_window", "unit": "pairs", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["c2c-96-r05.bands-batched"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("c2c-96-r05.bands-batched", root=tmp_path, here=here)
    assert cell.config["grid"] == [96, 96, 96] and cell.traffic["fence_every"] == 8
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_window", "setup_s"}
    assert cell.per_layer == []  # every per-layer metric names its cells
    ctx = SimpleNamespace(window={"pairs": 40, "seconds": 2.0})
    assert spec.reader("pairs_per_window", here)(ctx) == 40
    assert spec.reader("pairs_per_s", here)(ctx) == 20.0


def test_window_readers():
    lat = [2.0 + 0.01 * i for i in range(200)]
    ctx = SimpleNamespace(setup_s=12.5, profile=None,
                          window={"pairs": 200, "seconds": 0.5, "latency_ms": lat,
                                  "host_call_s": [1e-4] * 200})
    read = lambda name: spec.reader(name)(ctx)
    assert read("pairs_per_s") == 400.0 and read("setup_s") == 12.5
    assert read("pair_ms_p50") == pytest.approx(statistics.median(lat))
    assert read("pair_ms_p95") == pytest.approx(statistics.quantiles(lat, n=20)[18])
    assert read("host_call_ms.ahead") == pytest.approx(0.1) == read("host_call_ms.sync")
    for name in ("k1_ms_per_pair", "k2_ms_per_pair", "torch_ops_ms_per_pair",
                 "graph_copy_ms_per_pair", "device_idle_pct.ahead"):
        assert read(name) is None  # nothing traced: nothing to read, never 0
