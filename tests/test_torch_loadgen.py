"""The port's serving programs: loadgen and fleetstat, on the CPU.

``python -m spfft_tpu_torch.programs.loadgen`` drives the port's service
open-loop and writes the JAX package's report schema
(``spfft_tpu.serve.loadgen/1``); every row keeps the accounting identity
``offered == completed + rejected + shed + deadline_miss + failed``. The
cases: the in-process service (batch-fused and split-phase, graph-scheduled
with a second geometry, the driving hooks), the default device refusing
without a card, and the two-worker cluster with one worker SIGKILLed (the
survivor keeps serving, the fleet document passes both packages'
validators). ``fleetstat`` keeps the JAX program's exit codes: 0 clean, 1
no host answered, 3 validation findings.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from spfft_tpu.obs import fleet as jfleet
from spfft_tpu_torch import ProcessingUnit, obs
from spfft_tpu_torch.obs import fleet
from spfft_tpu_torch.programs import fleetstat, loadgen
from spfft_tpu_torch.serve import TransformService
from spfft_tpu_torch.serve.rpc import RpcServer

FAST = ["--device", "cpu", "-d", "8", "8", "8", "-s", "0.8", "--rate", "60",
        "--duration", "0.4", "--settle-s", "30"]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    obs.enable()
    obs.clear()
    monkeypatch.delenv("SPFFT_TPU_BATCH_FUSE", raising=False)
    yield


def _identity(row):
    return row["offered"] == (row["completed"] + row["rejected"] + row["shed"]
                              + row["deadline_miss"] + row["failed"])


def _run(tmp_path, *extra, hooks=None):
    out = tmp_path / "lg.json"
    assert loadgen.main([*FAST, *extra, "-o", str(out)], hooks=hooks) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("fuse", ["1", "0"])
def test_in_process_ramp_report(tmp_path, fuse):
    consumed, steps = [], []
    hooks = {"consume": lambda r: consumed.append(r.shape),
             "step": lambda svc, row, samples: steps.append((svc.stats(), row, samples))}
    doc = _run(tmp_path, "--ramp", "1", "2", "--batch-fuse", fuse, "--sample", "2",
               hooks=hooks)
    assert doc["schema"] == loadgen.LOADGEN_SCHEMA == "spfft_tpu.serve.loadgen/1"
    assert doc["config"]["batch_fuse"] is (fuse == "1")
    assert doc["config"]["device"] == "cpu" and doc["config"]["dtype"] == "f64"
    assert [r["key"] for r in doc["rows"]] == [
        "serve:8x8x8:s80:c2c:f64:t2:x1", "serve:8x8x8:s80:c2c:f64:t2:x2"]
    for row in doc["rows"]:
        assert _identity(row), row
        assert row["completed"] > 0 and row["failed"] == 0
        assert row["mean_batch_occupancy"] >= 1.0
        assert "coalesced" in row["phases"]
    assert len(steps) == 2 and all(s[0]["queue_high_water"] <= s[0]["queue_capacity"]
                                   for s in steps)
    # the step hook saw the live service and the kept samples: tensors
    # equal to a fresh plan's single backward of the same payload
    trip = np.asarray(loadgen_triplets())
    from spfft_tpu_torch import Transform, TransformType

    ref = Transform(ProcessingUnit.HOST, TransformType.C2C, 8, 8, 8, indices=trip)
    for _, _, samples in steps:
        assert 0 < len(samples) <= 2
        for g, payload, result in samples:
            assert g == 0 and torch.is_tensor(result)
            assert torch.equal(result, ref.backward(payload))
    assert consumed and all(s == (8, 8, 8) for s in consumed)
    assert doc["service"]["config"]["batch_fuse"] is (fuse == "1")


def loadgen_triplets():
    import spfft_tpu_torch as sp

    return sp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)


def test_sched_mode_with_a_second_geometry(tmp_path):
    marks = []
    doc = _run(tmp_path, "--ramp", "1", "--sched", "1", "--mix", "12", "12", "12", "0.5",
               "--dtype", "float32",
               hooks={"during": lambda svc, step: marks.append((step, svc.stats()["sched"]))})
    row, = doc["rows"]
    assert row["key"] == "serve:8x8x8:s80:mix12x12x12:s50:c2c:f32:t2:x1"
    assert _identity(row) and row["completed"] > 0
    assert "completed_after_kill" not in row  # a hook's mark is not a kill
    assert marks == [(0, True)]
    assert doc["service"]["stats"]["plan_cache_entries"] == 2
    assert doc["config"]["sched"] is True and doc["config"]["dtype"] == "f32"


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from spfft_tpu_torch.errors import GPUNoDeviceError

    with pytest.raises(GPUNoDeviceError):
        loadgen.main(["-d", "8", "8", "8", "--ramp", "1", "--duration", "0.1",
                      "-o", str(tmp_path / "x.json")])
    with pytest.raises(SystemExit):
        loadgen.main([*FAST, "--kill-host", "0"])


def test_cluster_survives_a_killed_worker(tmp_path):
    """Two spawned CPU workers, worker 1 SIGKILLed in the first measured
    step: every request accounted, work completes after the kill, the lost
    host is in the fleet document, which both packages' validators pass."""
    doc = _run(tmp_path, "--ramp", "1", "1", "--hosts", "2", "--kill-host", "1",
               "--kill-at", "0.3")
    first, second = doc["rows"]
    assert first["key"].endswith(":h2:x1:chaos-kill")
    for row in (first, second):
        assert _identity(row), row
    assert first["completed_after_kill"] > 0
    assert second["completed"] > 0
    svc = doc["service"]
    assert [h["lost"] for h in svc["hosts"]] == [False, True]
    assert svc["fleet"]["hosts"]["host1"]["state"] == "lost"
    assert fleet.validate_fleet(svc["fleet"]) == [] == jfleet.validate_fleet(svc["fleet"])
    assert doc["metrics"]["counters"]['hosts_lost_total{host="host1"}'] == 1
    assert doc["config"]["topology"] and doc["config"]["hosts"] == 2


# ---- fleetstat ------------------------------------------------------------------


def test_fleetstat_scrape_prom_and_check(tmp_path, capsys):
    svc = TransformService(ProcessingUnit.HOST, start=False)
    server = RpcServer(svc, port=0, timeout_s=5.0)
    try:
        obs.counter("serve_batches_total").inc(3)
        out = tmp_path / "fleet.json"
        assert fleetstat.main(["--host", f"host0={server.address}", "-o", str(out)]) == 0
        doc = json.loads(out.read_text())
        assert jfleet.validate_fleet(doc) == []
        assert doc["counters"]['serve_batches_total{host="host0"}'] == 3
        assert fleetstat.main(["--host", f"host0={server.address}", "--prom"]) == 0
        assert 'spfft_tpu_serve_batches_total{host="host0"} 3' in capsys.readouterr().out
        assert fleetstat.main(["--check", str(out)]) == 0
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps(dict(doc, schema="spfft_tpu.obs.fleet/999")))
        assert fleetstat.main(["--check", str(bad)]) == 3
    finally:
        server.close()
        svc.close()
    assert fleetstat.main([]) == 1
    assert fleetstat.main(["--host", "host0=127.0.0.1:9", "--timeout-s", "0.5"]) == 1


def test_a_slow_generator_leaves_arrivals_unoffered():
    """A submit slower than the arrival clock: the window closes on time,
    the arrivals not yet submitted are not offered, and the accounting
    identity holds over the offered ones."""
    import time

    from spfft_tpu_torch.serve.queue import Ticket

    class _Slow:
        def submit(self, *a, **kw):
            time.sleep(0.05)
            t = Ticket("t")
            t.resolve(torch.zeros(1))
            return t

    t0 = time.perf_counter()
    row = loadgen.run_step(
        _Slow(), key="slow", rate=200.0, duration=0.3, tenants=1, trip=None,
        values=np.ones(3), dims=(4, 4, 4), transform_type=0, timeout_s=0.0,
        flops_per_transform=1.0, settle_s=5.0, rng=np.random.default_rng(0), submitters=2)
    assert time.perf_counter() - t0 < 2.0
    assert row["target_rate"] == 200.0 and row["submitters"] == 2
    assert 0 < row["offered"] < 60 and row["unoffered"] == 60 - row["offered"]
    assert row["offered_rate"] < 100
    assert row["completed"] == row["offered"] and _identity(row)
