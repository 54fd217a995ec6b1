"""The port's runtime lockdep validator (``spfft_tpu_torch.analysis.lockdep``).

Twins of the JAX package's lockdep scenarios (``tests/test_lockdep.py``),
each run once under the JAX package's ``spfft_tpu/analysis/lockdep.py``
(loaded standalone, with no jax) and once under the port's: acquisition
edges (recorded at the attempt), RLock re-entry exempt, the same-site
self-edge, blocking waits, the cross-thread handoff, uninstall. The two
reports must be equal once the schema and paths are renamed, and so must
``crosscheck`` and ``merge_reports`` on one shared report and static graph.
Then the port's own armed paths: ``SPFFT_TPU_LOCKDEP=1`` installs at package
import before any submodule creates a lock (and an unarmed import loads
nothing of it), the report dumped at exit cross-checks green against SA011's
static graph, an armed serving run gives results bitwise equal to an unarmed
one, and ``hostmesh.spawn_workers(lockdep_dir=)`` writes one report per
worker host.

A scenario forces ``_in_package`` open so locks created HERE record; each
side is uninstalled and reset before the other is installed (the patch is
process-global state, like the fault plane).
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_ANALYZE = ROOT / "spfft_tpu_torch" / "programs" / "analyze.py"
JAX_ANALYZE = ROOT / "programs" / "analyze.py"


def _load_program(name: str, path: Path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


analysis = _load_program("spfft_tpu_torch_analyze_program", PORT_ANALYZE).load_analysis()
jax_side = _load_program("spfft_tpu_analyze_program", JAX_ANALYZE).load_analysis()
lockdep = analysis.lockdep
jax_lockdep = jax_side.lockdep
locks_mod = analysis.locks


def in_port_terms(obj):
    """A JAX lockdep document (report, cross-check) with its schema and
    paths renamed into the port's package."""
    return json.loads(re.sub(r"spfft_tpu(?!_torch)", "spfft_tpu_torch", json.dumps(obj)))


def as_jax(doc: dict) -> dict:
    """A port report handed to the JAX module: only the schema differs."""
    return dict(doc, schema=jax_lockdep.SCHEMA)


EMPTY_STATIC = {"locks": {}, "edges": []}


def _armed_run(ld, monkeypatch, scenario):
    monkeypatch.setattr(ld, "_in_package", lambda rel: True)
    ld.install()
    ld.reset()
    try:
        out = scenario()
        return ld.report(), out
    finally:
        ld.uninstall()
        ld.reset()
        monkeypatch.undo()


@pytest.fixture
def twin(monkeypatch):
    """``twin(scenario, static=...)`` runs ``scenario`` (which creates and
    takes locks through ``threading``) once under the JAX package's lockdep
    and once under the port's, asserts the reports, and their cross-checks
    against ``static``, equal up to the renamed names, and returns the
    port's report with what the port's run of ``scenario`` returned."""

    def run(scenario, static=EMPTY_STATIC):
        want, _ = _armed_run(jax_lockdep, monkeypatch, scenario)
        got, out = _armed_run(lockdep, monkeypatch, scenario)
        assert not jax_lockdep.validate_report(want), jax_lockdep.validate_report(want)
        assert not lockdep.validate_report(got), lockdep.validate_report(got)
        assert got == in_port_terms(want)
        assert lockdep.crosscheck(got, static) == in_port_terms(
            jax_lockdep.crosscheck(as_jax(got), static))
        return got, out

    return run


def test_edges_cycles_and_schema(twin):
    def scenario():
        A = threading.Lock()
        B = threading.Lock()
        for _ in range(2):
            with A:
                with B:
                    pass
        with B:
            with A:
                pass
        return A, B

    doc, (A, B) = twin(scenario)
    assert doc["schema"] == "spfft_tpu_torch.analysis.lockdep/1"
    ids = {lk["id"] for lk in doc["locks"]}
    assert len(ids) == 2 and all("test_torch_lockdep" in i for i in ids)
    counts = {(e["from"], e["to"]): e["count"] for e in doc["edges"]}
    assert counts == {(A.lock_id, B.lock_id): 2, (B.lock_id, A.lock_id): 1}
    assert len(doc["cycles"]) == 1 and len(doc["cycles"][0]) == 2
    chk = lockdep.crosscheck(doc, EMPTY_STATIC)
    assert [f["kind"] for f in chk["findings"]] == ["cycle"]
    json.dumps(doc)


def test_rlock_reentry_is_not_an_edge(twin):
    def scenario():
        R = threading.RLock()
        with R:
            with R:
                pass

    doc, _ = twin(scenario)
    assert doc["edges"] == [] and doc["cycles"] == []
    assert [lk["kind"] for lk in doc["locks"]] == ["rlock"]


def test_same_site_instances_record_a_self_edge(twin):
    def make():
        return threading.Lock()

    def scenario():
        a, b = make(), make()
        with a:
            with b:
                pass
        return a, b

    doc, (a, b) = twin(scenario)
    assert a.lock_id == b.lock_id
    assert [(e["from"], e["to"]) for e in doc["edges"]] == [(a.lock_id, a.lock_id)]
    chk = lockdep.crosscheck(doc, EMPTY_STATIC)
    assert [f["kind"] for f in chk["findings"]] == ["same-site-nesting"]
    assert "ABBA" in chk["findings"][0]["message"]


def test_edge_recorded_at_attempt_even_when_acquire_fails(twin):
    def scenario():
        A = threading.Lock()
        B = threading.Lock()
        B.acquire()
        with A:
            assert not B.acquire(False)
        B.release()
        return A, B

    doc, (A, B) = twin(scenario)
    pairs = {(e["from"], e["to"]) for e in doc["edges"]}
    assert (A.lock_id, B.lock_id) in pairs


def test_condition_wait_with_other_lock_held_is_blocking(twin):
    def held():
        A = threading.Lock()
        cv = threading.Condition()
        with A:
            with cv:
                for _ in range(2):
                    cv.wait(0.01)
        return A, cv

    def alone():
        cv = threading.Condition()
        with cv:
            cv.wait(0.01)

    doc, (A, cv) = twin(held)
    row = doc["blocking"][0]
    assert row["lock"] == cv.lock_id and A.lock_id in row["held"] and row["count"] == 2
    assert "blocking" in [f["kind"] for f in lockdep.crosscheck(doc, EMPTY_STATIC)["findings"]]
    doc, _ = twin(alone)
    assert doc["blocking"] == []


def test_event_wait_with_lock_held_is_blocking(twin):
    def scenario():
        A = threading.Lock()
        ev = threading.Event()
        ev.set()
        with A:
            ev.wait(0.01)
        return ev

    doc, ev = twin(scenario)
    assert any(r["lock"] == ev.lock_id for r in doc["blocking"])


def test_cross_thread_handoff_observed(twin):
    def scenario():
        A = threading.Lock()
        B = threading.Lock()
        gate = threading.Barrier(2, timeout=10)

        def ordered(first, second):
            gate.wait()
            with first:
                with second:
                    pass

        threads = [threading.Thread(target=ordered, args=pair, daemon=True)
                   for pair in ((A, B), (B, A))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)

    doc, _ = twin(scenario)
    assert len(doc["cycles"]) == 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_uninstall_restores_factories_and_foreign_locks_pass_through(side):
    ld = jax_lockdep if side == "jax" else lockdep
    real = threading.Lock
    ld.install()
    try:
        assert threading.Lock is not real
        ld.reset()
        lock = threading.Lock()  # tests/ is not the package: passthrough
        assert not hasattr(lock, "lock_id")
        assert ld.report()["locks"] == []
    finally:
        ld.uninstall()
        ld.reset()
    assert threading.Lock is real


@pytest.mark.parametrize("rel,recorded", [
    ("spfft_tpu_torch/serve/queue.py", True),
    ("spfft_tpu_torch/ir/compile.py", True),
    ("spfft_tpu_torch/analysis/lockdep.py", False),
    ("spfft_tpu_torch/programs/loadgen.py", False),
    ("spfft_tpu_torch/examples/poisson.py", False),
    ("spfft_tpu_torch/native/abi.py", False),
    ("spfft_tpu/serve/queue.py", False),
    ("tests/test_torch_serve.py", False),
    ("/usr/lib/python3/dist-packages/torch/cuda/__init__.py", False),
])
def test_the_marker_matches_only_the_ports_package_code(rel, recorded):
    assert lockdep._in_package(rel) is recorded
    assert lockdep._rel_path(f"/x/checkout/{rel}") == (
        rel if rel.startswith("spfft_tpu_torch/") else f"/x/checkout/{rel}")


def test_crosscheck_stale_static_and_dynamic(twin):
    def scenario():
        A = threading.Lock()
        B = threading.Lock()
        with A:
            with B:
                pass
        return A, B

    doc, (A, B) = twin(scenario)
    site = {lk["id"]: (lk["file"], lk["line"]) for lk in doc["locks"]}
    known = {
        "locks": {
            "m.py::A": {"kind": "lock", "file": site[A.lock_id][0], "line": site[A.lock_id][1]},
            "m.py::B": {"kind": "lock", "file": site[B.lock_id][0], "line": site[B.lock_id][1]},
        },
        "edges": [["m.py::A", "m.py::B"]],
    }
    for static in (known, dict(known, edges=[]), EMPTY_STATIC):
        assert lockdep.crosscheck(doc, static) == in_port_terms(
            jax_lockdep.crosscheck(as_jax(doc), static))
    chk = lockdep.crosscheck(doc, known)
    assert chk["findings"] == [] and len(chk["explained"]["static"]) == 1
    chk = lockdep.crosscheck(doc, dict(known, edges=[]))
    assert [f["kind"] for f in chk["findings"]] == ["stale-static"]
    assert "static model is stale" in chk["findings"][0]["message"]
    assert "spfft_tpu_torch/analysis/locks.py" in chk["findings"][0]["message"]
    chk = lockdep.crosscheck(doc, EMPTY_STATIC)
    assert chk["findings"] == [] and len(chk["explained"]["dynamic"]) == 1


def test_merge_reports_sums_and_finds_the_cross_process_cycle():
    one = {"schema": lockdep.SCHEMA, "installed": True,
           "locks": [{"id": "a", "kind": "lock", "file": "f", "line": 1, "created": 1},
                     {"id": "b", "kind": "lock", "file": "f", "line": 2, "created": 1}],
           "edges": [{"from": "a", "to": "b", "file": "f", "line": 3, "count": 2}],
           "blocking": [{"lock": "b", "held": ["a"], "file": "f", "line": 5, "count": 1}],
           "cycles": [], "counts": {}}
    two = json.loads(json.dumps(one))
    two["edges"] = [{"from": "b", "to": "a", "file": "f", "line": 4, "count": 1}]
    merged = lockdep.merge_reports([one, two])
    assert merged == in_port_terms(jax_lockdep.merge_reports([as_jax(one), as_jax(two)]))
    assert [lk["created"] for lk in merged["locks"]] == [2, 2]
    assert merged["blocking"][0]["count"] == 2
    assert merged["cycles"] == [["a", "b"]]
    assert not lockdep.validate_report(merged)
    assert lockdep.crosscheck(merged, EMPTY_STATIC) == in_port_terms(
        jax_lockdep.crosscheck(as_jax(merged), EMPTY_STATIC))


def test_static_graph_holds_the_ports_module_locks():
    static = locks_mod.static_graph(analysis.Tree(root=ROOT))
    for lock_id, rel in (
        ("spfft_tpu_torch/obs/registry.py::_lock", "spfft_tpu_torch/obs/registry.py"),
        ("spfft_tpu_torch/ir/compile.py::_CAPTURE_LOCK", "spfft_tpu_torch/ir/compile.py"),
        ("spfft_tpu_torch/faults/plane.py::_lock", "spfft_tpu_torch/faults/plane.py"),
    ):
        row = static["locks"].get(lock_id)
        assert row and row["file"] == rel and row["line"] > 0, lock_id
    assert static["edges"] and all(len(e) == 2 for e in static["edges"])
    assert not any(f.startswith("spfft_tpu/") for f in
                   (row["file"] for row in static["locks"].values()))


# ---- the armed process --------------------------------------------------------


def _python(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    full["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([full["PYTHONPATH"]] if full.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=full, timeout=600)


def _lockdep_check(*reports):
    return subprocess.run(
        [sys.executable, str(PORT_ANALYZE), "--lockdep-check", *map(str, reports)],
        capture_output=True, text=True, cwd=ROOT, timeout=300)


SERVE = (
    "import hashlib, numpy as np, torch\n"
    "import spfft_tpu_torch as sp\n"
    "trip = sp.create_spherical_cutoff_triplets(10, 10, 10, 0.7)\n"
    "rng = np.random.default_rng(5)\n"
    "vals = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))\n"
    "digest = hashlib.sha256()\n"
    "for sched in (False, True):\n"
    "    svc = sp.serve.TransformService(sp.ProcessingUnit.HOST, sched=sched,\n"
    "                                    queue_capacity=64, batch_max=4)\n"
    "    ts = [svc.submit(sp.TransformType.C2C, (10, 10, 10), trip, vals * (k + 1))\n"
    "          for k in range(8)]\n"
    "    for t in ts:\n"
    "        digest.update(t.result(timeout=120).cpu().numpy().tobytes())\n"
    "    svc.close()\n"
    "from spfft_tpu_torch.analysis import lockdep\n"
    "print('installed', lockdep.installed())\n"
    "print('digest', digest.hexdigest())\n"
)


def test_armed_serving_dumps_a_green_report_and_bitwise_results(tmp_path):
    """SPFFT_TPU_LOCKDEP=1 installs at import; serving (plain and with the
    scheduler) under it gives the unarmed results bitwise; the report dumped
    at exit records the port's module locks, created before any submodule
    import ran, and cross-checks green against the static graph."""
    report = tmp_path / "lockdep.json"
    armed = _python(SERVE, SPFFT_TPU_LOCKDEP="1", SPFFT_TPU_LOCKDEP_REPORT=str(report))
    plain = _python(SERVE, SPFFT_TPU_LOCKDEP="")
    assert armed.returncode == 0, armed.stdout + armed.stderr
    assert plain.returncode == 0, plain.stdout + plain.stderr
    assert "installed True" in armed.stdout and "installed False" in plain.stdout
    digests = [line for r in (armed, plain) for line in r.stdout.splitlines()
               if line.startswith("digest")]
    assert len(digests) == 2 and digests[0] == digests[1]
    doc = json.loads(report.read_text())
    assert not lockdep.validate_report(doc)
    files = {lk["file"] for lk in doc["locks"]}
    for rel in ("spfft_tpu_torch/obs/registry.py", "spfft_tpu_torch/obs/trace.py",
                "spfft_tpu_torch/faults/plane.py", "spfft_tpu_torch/ir/compile.py",
                "spfft_tpu_torch/verify/breaker.py", "spfft_tpu_torch/serve/queue.py"):
        assert rel in files, (rel, sorted(files))
    assert all(f.startswith("spfft_tpu_torch/") for f in files), sorted(files)
    assert doc["edges"] and doc["cycles"] == []
    r = _lockdep_check(report)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lockdep cross-check (1 report(s))" in r.stdout


def test_unarmed_import_installs_nothing_and_loads_no_analysis():
    r = _python(
        "import sys, threading\n"
        "import spfft_tpu_torch\n"
        "assert 'spfft_tpu_torch.analysis' not in sys.modules\n"
        "assert not hasattr(threading.Lock(), 'lock_id')\n"
        "from spfft_tpu_torch.analysis import lockdep\n"
        "assert not lockdep.installed()\n"
        "print('unarmed ok')\n",
        SPFFT_TPU_LOCKDEP="")
    assert r.returncode == 0 and "unarmed ok" in r.stdout, r.stdout + r.stderr


def test_lockdep_check_trips_on_a_cycle_and_on_a_bad_report(tmp_path):
    doc = {"schema": lockdep.SCHEMA, "installed": True, "locks": [],
           "edges": [{"from": "x::1", "to": "y::2", "file": "f", "line": 1, "count": 1},
                     {"from": "y::2", "to": "x::1", "file": "f", "line": 2, "count": 1}],
           "blocking": [], "cycles": [["x::1", "y::2"]],
           "counts": {"locks": 0, "edges": 2, "blocking": 0}}
    path = tmp_path / "r.json"
    path.write_text(json.dumps(doc))
    r = _lockdep_check(path)
    assert r.returncode == 3 and "[lockdep:cycle]" in r.stdout, r.stdout + r.stderr
    path.write_text(json.dumps({"schema": "spfft_tpu.analysis.lockdep/1"}))
    assert _lockdep_check(path).returncode == 2


def test_spawned_workers_write_one_report_per_host(tmp_path):
    """``spawn_workers(lockdep_dir=)`` arms lockdep in every worker with its
    own report (the folder made if missing); a clean stop writes both, and
    they cross-check green merged and one by one. ``child_env`` still drops
    a parent's report path."""
    code = (
        "import numpy as np\n"
        "import spfft_tpu_torch as sp\n"
        "from spfft_tpu_torch import hostmesh\n"
        "from spfft_tpu_torch.serve.cluster import ClusterFront\n"
        f"ws = hostmesh.spawn_workers(2, device='cpu', lockdep_dir={str(tmp_path / 'hosts')!r})\n"
        "try:\n"
        "    front = ClusterFront([w.address for w in ws], platform='cpu')\n"
        "    trip = sp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)\n"
        "    vals = np.ones(len(trip), complex)\n"
        "    ts = [front.submit(sp.TransformType.C2C, (8, 8, 8), trip, vals * k)\n"
        "          for k in range(1, 5)]\n"
        "    for t in ts:\n"
        "        t.result(timeout=120)\n"
        "    front.close()\n"
        "finally:\n"
        "    hostmesh.stop_workers(ws)\n"
        "env = hostmesh.child_env({}, devices=None)\n"
        "assert 'SPFFT_TPU_LOCKDEP_REPORT' not in env\n"
        "print('fleet ok')\n"
    )
    r = _python(code, SPFFT_TPU_LOCKDEP_REPORT=str(tmp_path / "parent.json"))
    assert r.returncode == 0 and "fleet ok" in r.stdout, r.stdout + r.stderr
    reports = [tmp_path / "hosts" / "host0.json", tmp_path / "hosts" / "host1.json"]
    for path in reports:
        doc = json.loads(path.read_text())
        assert not lockdep.validate_report(doc) and doc["installed"]
        assert doc["locks"], path
        assert _lockdep_check(path).returncode == 0
    r = _lockdep_check(*reports)
    assert r.returncode == 0 and "(2 report(s))" in r.stdout, r.stdout + r.stderr
