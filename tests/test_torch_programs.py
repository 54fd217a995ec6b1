"""The port's diagnostic and benchmark programs (spfft_tpu_torch.programs:
report, trace, verify, profile, fbench, dbench, perf_gate,
discipline_compare) against the JAX package's (programs/*.py, loaded by
path), and the library functions they need.

Each program runs with ``--device cpu`` at a small size on the same seeded
inputs as the JAX program; the documents are compared as each test states.
The JAX programs run ``engine="xla"`` (or their CPU default, which is
``xla``): the JAX MXU engine cannot be imported on this jax. Times are
indicative on the CPU and never compared. Without ``--device cpu`` and
without a card each program raises ``GPUNoDeviceError``.
"""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import obs as jobs
from spfft_tpu.obs import perf as jperf
from spfft_tpu.obs import trace as jtrace
from spfft_tpu_torch import obs
from spfft_tpu_torch.obs import perf
from spfft_tpu_torch.programs import (dbench, discipline_compare, fbench, perf_gate, profile,
                                      report, trace, verify)

ROOT = Path(__file__).resolve().parent.parent
PROGRAMS = ("report", "trace", "verify", "profile", "fbench", "dbench", "perf_gate",
            "discipline_compare")
CPU = ["--device", "cpu"]


def jax_program(name):
    """The JAX package's ``programs/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_program_{name}",
                                                  ROOT / "programs" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _restore():
    for pkg in (spfft_tpu, tp):
        pkg.verify.breaker.reset()
    yield
    spfft_tpu.faults.disarm()
    tp.faults.disarm()
    for pkg in (spfft_tpu, tp):
        pkg.verify.breaker.reset()
        pkg.obs.trace.disable()
        pkg.timing.disable()
        pkg.timing.clear()


# ---- what the port imports ------------------------------------------------------------

IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|spfft_tpu|programs)(?:[\s.]|$)", re.M)
SELF_LOADERS = ("spfft_tpu_torch/programs/analyze.py", "spfft_tpu_torch/programs/lint.py")


@pytest.mark.parametrize("path", sorted(
    [p for p in (ROOT / "spfft_tpu_torch").rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    src = path.read_text()
    assert not IMPORT.findall(src), path
    # nor a root programs/ file by path; the static-analysis gate loads its
    # own analysis package (and lint.py the gate beside it) by path, so that
    # neither spfft_tpu_torch/__init__ nor torch is imported
    if path.relative_to(ROOT).as_posix() in SELF_LOADERS:
        assert "spfft_tpu_torch" in src and not re.search(r"[\"']programs[\"']", src), path
        assert not re.search(r"run_path|runpy", src), path
    else:
        assert not re.search(r"spec_from_file_location|run_path|runpy", src), path


@pytest.mark.parametrize("name", PROGRAMS)
def test_every_program_has_main_argv(name):
    import inspect

    module = importlib.import_module(f"spfft_tpu_torch.programs.{name}")
    assert list(inspect.signature(module.main).parameters) == ["argv"]


# ---- validate_report and validate_scaling_doc -----------------------------------------

def _drop(doc, path):
    """``doc`` with the key at dotted ``path`` removed (a deep copy)."""
    doc = json.loads(json.dumps(doc))
    *head, last = path.split(".")
    node = doc
    for k in head:
        node = node[int(k)] if isinstance(node, list) else node[k]
    if isinstance(node, list):
        node.pop(int(last))
    else:
        node.pop(last)
    return doc


@pytest.fixture(scope="module")
def report_doc(tmp_path_factory):
    out = tmp_path_factory.mktemp("report") / "r.json"
    assert report.main(["-d", "8", "8", "8", "--shards", "2", "-o", str(out), *CPU]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("drop", [None, "plan", "metrics", "plan.dims", "plan.exchange",
                                  "metrics.counters", "metrics.schema"])
def test_validate_report_is_the_jax_packages(report_doc, drop):
    doc = report_doc if drop is None else _drop(report_doc, drop)
    got = obs.validate_report(doc)
    assert got == jobs.validate_report(doc)  # equal lists
    assert (got == []) == (drop is None)


@pytest.fixture(scope="module")
def scaling_doc(tmp_path_factory):
    out = tmp_path_factory.mktemp("dbench") / "d.json"
    assert dbench.main(["--devices", "2", "--dim", "8", "--sparsity", "0.9", "--mesh", "slab",
                        "--scaling", "strong", "--repeats", "1", "--chain", "2",
                        "--engine", "xla", "-o", str(out), *CPU]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("doctor", [None, "schema", "config", "rows.0.key", "rows.0.scaling",
                                    "rows.0.stages.0.flops", "rows.0.attribution.method",
                                    "wrong-schema"])
def test_validate_scaling_doc_is_the_jax_packages(scaling_doc, doctor):
    if doctor == "wrong-schema":
        doc = dict(scaling_doc, schema="spfft_tpu.obs.perf.scaling/0")
    else:
        doc = scaling_doc if doctor is None else _drop(scaling_doc, doctor)
    got = perf.validate_scaling_doc(doc)
    assert got == jperf.validate_scaling_doc(doc)  # equal lists
    assert (got == []) == (doctor is None)
    assert perf.SCALING_SCHEMA == jperf.SCALING_SCHEMA


# ---- report ------------------------------------------------------------------------------

CARD_FIELDS = ("kind", "transform_type", "dims", "num_elements", "num_sticks", "nnz_fraction",
               "dtype", "precision", "policy", "platform", "degradations", "verification")
MESH_FIELDS = ("num_shards", "mesh", "decomposition", "num_sticks_per_shard",
               "local_z_lengths")


@pytest.mark.parametrize("argv", [["-d", "8", "8", "8"], ["-d", "8", "8", "9", "--r2c"],
                                  ["-d", "8", "8", "8", "--shards", "4", "--exchange", "BUFFERED"],
                                  ["-d", "8", "8", "8", "--pencil", "2", "2", "--exchange",
                                   "BUFFERED"]],
                         ids=["local", "r2c", "slab4", "pencil2x2"])
def test_report_cards_match_the_jax_program(tmp_path, capsys, argv):
    """The documents validate under both packages' validators; the cards'
    shared sections are equal (exactly: the same plan decisions). The mesh
    plans name a padded discipline: DEFAULT resolves by each package's own
    rule (``parallel/policy.py``), and the JAX pencil engine's UNBUFFERED
    off the TPU is its chain, whose wire accounting is not the one-shot's."""
    common = [*argv, "-s", "0.4", "--engine", "xla", "--no-compiled"]
    assert jax_program("report").main([*common, "-o", str(tmp_path / "j.json")]) == 0
    assert report.main([*common, "-o", str(tmp_path / "p.json"), *CPU]) == 0
    capsys.readouterr()
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "p.json").read_text())
    assert jobs.validate_report(got) == [] == obs.validate_report(got)
    assert set(got) == set(want) == {"plan", "metrics", "run_id", "verify_mode"}
    pc, jc = got["plan"], want["plan"]
    for key in CARD_FIELDS + (MESH_FIELDS if pc["kind"] == "distributed" else ()):
        assert pc[key] == jc[key], key
    if pc["kind"] == "distributed":
        for key in ("discipline", "wire_dtype", "wire_bytes", "overlap_chunks"):
            assert pc["exchange"][key] == jc["exchange"][key], key
    assert got["verify_mode"] == want["verify_mode"] == "off"
    assert any(k.startswith("transforms_total") for k in got["metrics"]["counters"])


def test_report_without_roundtrip_and_compiled_flag(tmp_path, capsys):
    out = tmp_path / "p.json"
    assert report.main(["-d", "8", "8", "8", "--no-roundtrip", "--no-compiled", "-o", str(out),
                        *CPU]) == 0
    doc = json.loads(out.read_text())
    assert "compiled" not in doc["plan"] and obs.validate_report(doc) == []
    assert capsys.readouterr().out.startswith("{")


# ---- trace -------------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_trace_snapshots_validate_and_name_the_same_events(tmp_path, capsys, shards):
    common = ["-d", "8", "8", "8", "--engine", "xla", "--shards", str(shards)]
    for pkg in (spfft_tpu, tp):
        pkg.obs.trace.disable()  # enable() then installs a fresh recorder
    assert jax_program("trace").main([*common, "-o", str(tmp_path / "j.json"),
                                      "--chrome", str(tmp_path / "jc.json")]) == 0
    assert trace.main([*common, "-o", str(tmp_path / "p.json"),
                       "--chrome", str(tmp_path / "pc.json"), "--last", "3", *CPU]) == 0
    printed = capsys.readouterr().out
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "p.json").read_text())
    assert jtrace.validate_trace(got) == [] == obs.trace.validate_trace(got)
    assert jtrace.validate_trace(want) == []
    assert [(e["name"], e["ph"]) for e in got["events"]] == [
        (e["name"], e["ph"]) for e in want["events"]]  # equal in order
    chrome = json.loads((tmp_path / "pc.json").read_text())
    assert len(chrome["traceEvents"]) > len(got["events"]) // 2
    assert re.search(rf"{len(got['events'])} events recorded .*, 3 shown", printed)


def test_trace_malformed_event_exits_nonzero(monkeypatch, capsys):
    real = obs.trace.snapshot

    def broken():  # an event of a phase and a name outside the vocabulary
        snap = real()
        snap["events"][0].update(ph="X", name="teleport")
        return snap

    monkeypatch.setattr(obs.trace, "snapshot", broken)
    assert trace.main(["-d", "8", "8", "8", *CPU]) == 1
    err = capsys.readouterr().err
    assert "INCOMPLETE" in err and "events[0].ph" in err and "events[0].name" in err


# ---- verify ------------------------------------------------------------------------------

@pytest.mark.parametrize("extra,rc", [([], 0), (["--inject", "engine.execute=corrupt:1.0"], 0),
                                      (["--mode", "strict", "--inject", "engine.execute=nan"], 3),
                                      (["--shards", "2"], 0)],
                         ids=["clean", "corrupt", "strict-nan", "shards2"])
def test_verify_exit_codes_and_sections_match_the_jax_program(tmp_path, capsys, extra, rc):
    """The same exit code, outcome, ``verification`` section keys and rungs
    as the JAX program; a verified round trip's residual at float64's bar."""
    common = ["-d", "8", "8", "8", *extra]
    assert jax_program("verify").main([*common, "-o", str(tmp_path / "j.json")]) == rc
    spfft_tpu.faults.disarm()  # the JAX program leaves its faults armed
    assert verify.main([*common, "-o", str(tmp_path / "p.json"), *CPU]) == rc
    capsys.readouterr()
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "p.json").read_text())
    assert set(got) == set(want)
    assert got["outcome"] == want["outcome"]
    assert set(got["verification"]) == set(want["verification"])
    assert [d["event"] for d in got["degradations"]] == [d["event"] for d in want["degradations"]]
    if rc == 0:
        assert got["roundtrip_residual"] < 1e-12
    assert tp.faults.armed() == {}  # armed for the round trips only


# ---- profile -----------------------------------------------------------------------------

def _perf_line(printed: str) -> dict:
    return next(json.loads(line) for line in printed.splitlines()
                if line.startswith("{") and '"spfft_tpu.obs.perf/1"' in line)


def test_profile_report_matches_the_jax_model(tmp_path, capsys):
    """The perf report validates, its stages sum to ``seconds_per_pair``
    (1e-12 relative), its model rows (stage, flops, bytes) equal the JAX
    program's exactly, and the trace file exists."""
    jax_program("profile").main(["-d", "16", "16", "16", "-r", "1", "--repeats", "1",
                                 "-o", str(tmp_path / "jax"), "--engine", "xla"])
    spfft_tpu.timing.disable()
    want = _perf_line(capsys.readouterr().out)
    out = profile.main(["-d", "16", "16", "16", "-r", "2", "--repeats", "1",
                        "-o", str(tmp_path / "port"), "--engine", "xla", *CPU])
    printed = capsys.readouterr().out
    got = _perf_line(printed)
    assert got == out["report"]
    assert jperf.validate_perf_report(got) == [] == perf.validate_perf_report(got)
    total = sum(r["seconds"] for r in got["stages"])
    assert abs(total - got["seconds_per_pair"]) <= 1e-12 * got["seconds_per_pair"]
    rows = lambda r: [(s["stage"], s["flops"], s["bytes"]) for s in r["stages"]]  # noqa: E731
    assert rows(got) == rows(want)
    assert got["attribution"]["flop_per_byte"] == want["attribution"]["flop_per_byte"] == 8.0
    trace_file = tmp_path / "port" / profile.TRACE_FILE
    assert trace_file.exists() and json.loads(trace_file.read_text())["traceEvents"]
    assert "traced roundtrips" in printed and "backward" in printed
    profiled = next(json.loads(line)["profile"] for line in printed.splitlines()
                    if line.startswith('{"profile"'))
    assert profiled["pairs"] == 2 and profiled["fused"] is False


# ---- fbench and perf_gate ----------------------------------------------------------------

FB = ["--dim", "8", "--radius", "0.8", "--pairs", "1", "--repeats", "2", "--warmup", "1",
      "--batches", "1", "2", "--engine", "xla"]


@pytest.fixture(scope="module")
def fbench_docs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fbench")
    assert jax_program("fbench").main([*FB, "-o", str(d / "j.json")]) == 0
    assert fbench.main([*FB, "-o", str(d / "p.json"), *CPU]) == 0
    return (json.loads((d / "j.json").read_text()), json.loads((d / "p.json").read_text()), d)


def test_fbench_rows_have_the_jax_keys(fbench_docs):
    want, got, _ = fbench_docs
    assert got["schema"] == want["schema"] == fbench.FBENCH_SCHEMA
    assert set(got) == set(want)
    assert [r["key"] for r in got["rows"]] == [r["key"] for r in want["rows"]]
    assert [set(r) for r in got["rows"]] == [set(r) for r in want["rows"]]
    for r in got["rows"]:
        if "perf" in r:
            assert jperf.validate_perf_report(r["perf"]) == []
            assert r["perf"]["attribution"]["batch"] == r["batch"]
        assert r["gflops"] > 0 and r["seconds_noise"] >= 0
    assert [r["fused"] for r in got["rows"][:2]] == [True, False]
    assert got["fused_over_staged"] > 0 and got["batch_over_single"] > 0


def test_perf_gate_passes_a_port_document_against_itself(fbench_docs, capsys):
    _, got, d = fbench_docs
    path = d / "p.json"
    doubled = d / "doubled.json"
    doubled.write_text(json.dumps(dict(got, rows=[dict(r, gflops=2 * r["gflops"])
                                                  for r in got["rows"]])))
    for gate in (perf_gate, jax_program("perf_gate")):
        assert gate.main([str(path), str(path)]) == 0
        assert gate.main([str(path), str(doubled)]) == 3
    assert "REGRESSION" in capsys.readouterr().out


def _doc(rows):
    return {"schema": perf.SCALING_SCHEMA, "config": {}, "rows": rows}


def _row(key, gflops, noise=0.0):
    return {"key": key, "gflops": gflops, "seconds_noise": noise}


# the three cases of tests/test_perf.py's gate tests: (current, baseline, argv, exit)
GATE_CASES = {
    "clean": ([_row("a", 1.0), _row("b", 2.0)], [_row("a", 1.0), _row("b", 2.0)], [], 0),
    "doctored": ([_row("a", 1.0), _row("b", 2.0)], [_row("a", 10.0), _row("b", 20.0)], [], 3),
    "noise-widens": ([_row("a", 0.6, 0.25)], [_row("a", 1.0, 0.25)], ["--tolerance", "0.1"], 0),
    "noise-capped": ([_row("a", 0.1, 5.0)], [_row("a", 1.0, 5.0)], ["--tolerance", "0.1"], 3),
    "disjoint": ([_row("a", 1.0)], [_row("zzz", 1.0)], [], 1),
    "no-rows": ([], [_row("a", 1.0)], [], 1),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_perf_gate_is_the_jax_gate(tmp_path, capsys, case):
    """The same exit code and the same verdict lines (stdout and stderr) as
    the JAX gate on the same documents."""
    cur_rows, base_rows, extra, rc = GATE_CASES[case]
    cur, base = tmp_path / "cur.json", tmp_path / "base.json"
    cur.write_text(json.dumps(_doc(cur_rows)))
    base.write_text(json.dumps(_doc(base_rows)))
    outs = []
    for gate in (jax_program("perf_gate"), perf_gate):
        assert gate.main([str(cur), str(base), *extra]) == rc
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and outs[0].err == outs[1].err
    assert perf_gate.DEFAULT_TOLERANCE == 0.35 and perf_gate.NOISE_CAP == 0.55


def test_perf_gate_writes_a_baseline_and_rejects_a_rowless_key(tmp_path, capsys):
    cur, base = tmp_path / "cur.json", tmp_path / "base.json"
    cur.write_text(json.dumps(_doc([_row("a", 1.0)])))
    assert perf_gate.main([str(cur), "--write-baseline", str(base)]) == 0
    assert json.loads(base.read_text()) == _doc([_row("a", 1.0)])
    cur.write_text(json.dumps(_doc([{"gflops": 1.0}])))
    assert perf_gate.main([str(cur), str(base)]) == 1
    assert "no scenario key" in capsys.readouterr().err


# ---- dbench ------------------------------------------------------------------------------

def test_dbench_rows_match_the_jax_program(tmp_path, capsys):
    """Both documents validate under both validators; the rows' keys (the
    scenario strings) and key sets are equal; the model's stage rows equal
    the JAX program's row by row."""
    common = ["--devices", "1", "2", "4", "--dim", "8", "--sparsity", "0.9", "--scaling",
              "strong", "weak", "--repeats", "1", "--chain", "2", "--engine", "xla",
              "--exchange", "BUFFERED"]  # DEFAULT resolves by each package's own rule
    assert jax_program("dbench").main([*common, "--cpu", "-o", str(tmp_path / "j.json")]) == 0
    assert dbench.main([*common, "--cpu", "-o", str(tmp_path / "p.json")]) == 0
    capsys.readouterr()
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "p.json").read_text())
    for doc in (want, got):
        assert jperf.validate_scaling_doc(doc) == [] == perf.validate_scaling_doc(doc)
    assert [r["key"] for r in got["rows"]] == [r["key"] for r in want["rows"]]
    assert [set(r) for r in got["rows"]] == [set(r) for r in want["rows"]]
    rows = lambda r: [(s["stage"], s["flops"], s["bytes"]) for s in r["stages"]]  # noqa: E731
    for g, w in zip(got["rows"], want["rows"]):
        assert rows(g) == rows(w), g["key"]
        assert g["wire_bytes_per_pair"] == w["wire_bytes_per_pair"]
    assert got["device"] == {"platform": "cpu", "count": 1, "kind": "cpu"}
    assert {r["decomposition"] for r in got["rows"]} == {"local", "slab", "pencil2"}


def test_dbench_pencil_shapes_and_overlap():
    assert [dbench.pencil_shape(p) for p in (4, 6, 8, 16)] == [(2, 2), (2, 3), (2, 4), (4, 4)]
    with pytest.raises(tp.InvalidParameterError, match="OVERLAPPED"):
        dbench.main(["--devices", "2", "--dim", "8", "--overlap", "1", "4", *CPU])


# ---- discipline_compare ------------------------------------------------------------------

@pytest.mark.parametrize("imbalance", ["0.0", "0.5"])
def test_discipline_compare_wire_bytes_are_the_jax_programs(capsys, imbalance):
    """The same wire bytes per discipline and shard count as the JAX
    program (exactly); every discipline's rounds 1 in the port."""
    common = ["--shards", "2", "4", "--dim", "8", "--sparsity", "0.6", "--repeats", "1",
              "--engine", "xla", "--imbalance", imbalance]
    want = jax_program("discipline_compare").main(common)
    got = discipline_compare.main([*common, *CPU])
    capsys.readouterr()
    assert [(r["P"], r["discipline"]) for r in got] == [(r["P"], r["discipline"]) for r in want]
    for g, w in zip(got, want):
        if not g["discipline"].startswith("DEFAULT"):
            assert g["wire_bytes"] == w["wire_bytes"], (g, w)
        assert g["rounds"] == 1 and g["transport"] == "device gather"
        assert g["ms_per_pair"] > 0
    default = [r for r in got if r["discipline"] == "DEFAULT:default"]
    assert all(r["provenance"] == "model" for r in default)
    by = {(r["P"], r["discipline"]): r for r in got}
    for r in default:
        assert r["wire_bytes"] == by[r["P"], {"COMPACT_BUFFERED": "COMPACT"}.get(
            r["resolved"], r["resolved"])]["wire_bytes"]


def test_discipline_compare_matrix_rows_gate(tmp_path, capsys, monkeypatch):
    # set here, so that the program's setdefault of the CPU trials ends with the test
    monkeypatch.setenv("SPFFT_TPU_TUNE_CPU", "1")
    monkeypatch.setenv("SPFFT_TPU_TUNE_REPEATS", "1")
    monkeypatch.setenv("SPFFT_TPU_WISDOM", str(tmp_path / "wisdom.json"))
    out = tmp_path / "m.json"
    assert discipline_compare.main([
        "--shards", "2", "--matrix", "--matrix-dims", "8", "--matrix-sparsity", "0.6",
        "--matrix-types", "c2c", "r2c", "--matrix-dtypes", "f32", "--matrix-batch", "2",
        "--matrix-overlap", "1", "tuned", "--repeats", "1", "--engine", "xla",
        "--json", str(out), *CPU]) == 0
    capsys.readouterr()
    doc = json.loads(out.read_text())
    assert perf.validate_scaling_doc(doc) == [] == jperf.validate_scaling_doc(doc)
    keys = [r["key"] for r in doc["rows"]]
    # a tuned cell's key names the discipline its trials chose, as in the
    # JAX program, so it may repeat an explicit cell's key
    assert len(keys) == 2 * (3 + 2)
    assert sum(k.endswith(":batch2:serial") for k in keys) == 2
    assert sum(k.endswith(":batch2:sched") for k in keys) == 2
    assert perf_gate.main([str(out), str(out)]) == 0
    tp.tuning.clear_memory()
    with pytest.raises(tp.InvalidParameterError, match="OVERLAPPED"):
        discipline_compare.main(["--shards", "2", "--matrix", "--matrix-overlap", "2",
                                 "--matrix-dims", "8", *CPU])


# ---- the perf model's balance ------------------------------------------------------------

def _cpu_plan():
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    return tp.Transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8, indices=trip,
                        engine="xla")


def test_flop_per_byte_is_the_jax_default_on_the_cpu(monkeypatch):
    monkeypatch.delenv(perf.FLOP_PER_BYTE_ENV, raising=False)
    t = _cpu_plan()
    assert perf.flop_per_byte(t.device) == 8.0 == perf.flop_per_byte() == jperf.flop_per_byte()
    assert perf.perf_report(t, 1e-3)["attribution"]["flop_per_byte"] == 8.0


def test_flop_per_byte_takes_the_cuda_constant_by_device(monkeypatch):
    """The choice by device, with a fake CUDA device (no card needed)."""
    monkeypatch.delenv(perf.FLOP_PER_BYTE_ENV, raising=False)
    assert perf.CUDA_FLOP_PER_BYTE > 0 and perf.CUDA_FLOP_PER_BYTE != 8.0
    assert perf.flop_per_byte(torch.device("cuda", 0)) == perf.CUDA_FLOP_PER_BYTE
    assert perf.flop_per_byte("cuda") == perf.CUDA_FLOP_PER_BYTE
    t = _cpu_plan()
    monkeypatch.setattr(type(t), "device", property(lambda self: torch.device("cuda", 0)))
    report = perf.perf_report(t, 1e-3)
    assert report["attribution"]["flop_per_byte"] == perf.CUDA_FLOP_PER_BYTE
    assert abs(sum(r["seconds"] for r in report["stages"]) - 1e-3) < 1e-15


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_the_knob_wins_on_every_device(monkeypatch, device):
    monkeypatch.setenv(perf.FLOP_PER_BYTE_ENV, "2.5")
    assert perf.flop_per_byte(device) == 2.5 == jperf.flop_per_byte()
    monkeypatch.setenv(perf.FLOP_PER_BYTE_ENV, "x")
    with pytest.raises(tp.InvalidParameterError):
        perf.flop_per_byte(device)


@pytest.mark.parametrize("balance", [0.37, 3.7, 37.0])
def test_fit_recovers_the_balance_of_model_made_times(balance):
    """Per-stage times made by the model itself at a known balance give that
    balance back (1e-4 relative) with a residual near 0."""
    cases = []
    for shards in (2, 4):
        trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8,
                                    trip, mesh=tp.make_fft_mesh(shards, device="cpu"),
                                    engine="xla")
        rows = perf.stage_model(t)
        ms = {k: 7.0 * v for k, v in perf.stage_shares(rows, balance).items()}
        cases.append((rows, ms))
    fit = perf.fit_flop_per_byte(cases)
    assert abs(fit["flop_per_byte"] / balance - 1) < 1e-4 and fit["residual"] < 1e-6


# ---- tuning.runner._stage_batch_inputs ---------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3])
def test_stage_batch_inputs_are_the_jax_packages(batch):
    from spfft_tpu.tuning import runner as jrunner

    from spfft_tpu_torch.tuning import runner

    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    jt = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, spfft_tpu.TransformType.C2C,
                             8, 8, 8, indices=trip, engine="xla", dtype=np.float64)
    pt = tp.Transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8, indices=trip,
                      engine="xla", dtype=np.float64)
    got = runner._stage_batch_inputs(pt, batch)
    want = jrunner._stage_batch_inputs(jt, batch)
    for g, w in zip(got, want):
        assert g.shape == (batch, len(trip)) and g.device == pt.device
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))  # bitwise


# ---- no fallback ---------------------------------------------------------------------------

NO_CARD = {
    "report": ["-d", "8", "8", "8"], "trace": ["-d", "8", "8", "8"],
    "verify": ["-d", "8", "8", "8"], "profile": ["-d", "8", "8", "8"],
    "fbench": ["--dim", "8"], "dbench": ["--devices", "2", "--dim", "8"],
    "discipline_compare": ["--shards", "2", "--dim", "8"],
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
@pytest.mark.parametrize("name", sorted(NO_CARD))
def test_without_a_card_each_program_raises(name):
    module = importlib.import_module(f"spfft_tpu_torch.programs.{name}")
    with pytest.raises(tp.GPUNoDeviceError):
        module.main(NO_CARD[name])
