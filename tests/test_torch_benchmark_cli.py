"""The port's benchmark programs (spfft_tpu_torch.programs.benchmark and
.bench) against the JAX package's (programs/benchmark.py, bench.py).

The stick models give the same arrays; ``main()`` at 8^3 on the CPU writes a
report with the JAX report's keys (the port adds ``roundtrip_residual`` to
``results``), whose plan card passes the JAX validator and whose timing tree
holds the benchmark's scopes; ``--mesh2`` runs the pencil decomposition and
takes the JAX program's ``-e`` values. ``-p gpu`` without a card, a
``--mesh2`` discipline the JAX program refuses and an unknown flag value
raise; nothing falls back.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import spfft_tpu_torch as tp
from spfft_tpu.obs import perf as jperf
from spfft_tpu.obs import plancard as jplancard
from spfft_tpu_torch.programs import bench, benchmark

ROOT = Path(__file__).resolve().parent.parent


def jax_benchmark():
    spec = importlib.util.spec_from_file_location("jax_benchmark_program",
                                                  ROOT / "programs" / "benchmark.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dims,sparsity,r2c", [((8, 8, 8), 1.0, False), ((8, 8, 8), 0.4, True),
                                               ((12, 10, 9), 0.3, False),
                                               ((12, 10, 9), 0.7, True)])
def test_stick_models_give_the_same_arrays(dims, sparsity, r2c):
    jb = jax_benchmark()
    want, want_n = jb.create_benchmark_triplets(*dims, sparsity, r2c)
    got, got_n = benchmark.create_benchmark_triplets(*dims, sparsity, r2c)
    assert got_n == want_n and np.array_equal(got, want) and got.dtype == want.dtype
    for shards in (1, 3, 4):
        a = benchmark.split_contiguous(got, got_n, shards, dims[2])
        b = jb.split_contiguous(want, want_n, shards, dims[2])
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def keys(tree):
    """The nested key structure of a JSON document (dict keys only)."""
    if isinstance(tree, dict):
        return {k: keys(v) for k, v in tree.items()}
    return None


def labels(node):
    out = {node["label"]}
    for sub in node["sub"]:
        out |= labels(sub)
    return out


@pytest.mark.parametrize("argv", [["-t", "c2c"], ["-t", "r2c", "--shards", "4", "--model",
                                                   "spherical", "-s", "0.5"],
                                  ["-t", "r2c", "--mesh2", "2", "2", "--model", "spherical",
                                   "-s", "0.5"]])
def test_main_writes_the_jax_report(tmp_path, capsys, argv):
    common = ["-d", "8", "8", "8", "-r", "2", "-p", "cpu", *argv]
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    if "--shards" not in argv and "--mesh2" not in argv:
        # the JAX program meshes over virtual devices itself
        jax_benchmark().main([*common, "-o", str(jax_out)])
    report, transforms = benchmark.main([*common, "-o", str(port_out)])
    assert json.loads(port_out.read_text()) == json.loads(json.dumps(report))
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex('{\n  "parameters"'):]) == {
        k: json.loads(json.dumps(report[k])) for k in ("parameters", "results")}
    res = report["results"]
    assert jplancard.validate_plan_card(res["plan"]) == []
    assert res["plan"]["platform"] == "cpu"
    assert res["roundtrip_residual"] < 1e-12
    assert {"Grid + Transform init", "warmup", "warmup chain", "benchmark loop",
            "multi backward", "dispatch all", "finalize all"} <= labels(report["timings"])
    assert jperf.validate_perf_report(
        tp.obs.perf.perf_report(transforms[0], res["wall_s_per_transform_pair"])) == []
    if jax_out.exists():
        want = json.loads(jax_out.read_text())
        got = json.loads(port_out.read_text())
        assert set(got) == set(want) == {"parameters", "results", "timings"}
        assert set(got["parameters"]) == set(want["parameters"])
        assert set(got["results"]) == set(want["results"]) | {"roundtrip_residual"}
        assert set(got["results"]["wisdom"]) == set(want["results"]["wisdom"])
        assert got["results"]["wisdom"] == want["results"]["wisdom"]
        assert set(got["timings"]) == set(want["timings"])
        for k in ("dim_x", "num_z_sticks", "num_elements", "effective_nnz_fraction",
                  "precision", "repeats"):
            assert got["parameters"][k] == want["parameters"][k], k
    else:
        assert res["exchange_wire_bytes"] == transforms[0].exchange_wire_bytes()
        assert report["parameters"]["shards"] == 4
        if "--mesh2" in argv:
            assert report["parameters"]["mesh2"] == [2, 2]
            assert res["plan"]["decomposition"] == "pencil2"
            assert res["plan"]["mesh"] == {"fft": 2, "fft2": 2}
            assert transforms[0].engine == "pencil2"


def test_gpu_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["-p", "gpu"], ["-p", "gpu", "--shards", "4"],
                 ["-p", "gpu", "--mesh2", "2", "2"]):
        with pytest.raises(tp.GPUNoDeviceError):
            benchmark.main(["-d", "8", "8", "8", "-r", "1", "-o", str(tmp_path / "x.json"),
                            *argv])
    with pytest.raises(tp.GPUNoDeviceError):
        bench.main(["--dim", "8"])


def test_mesh2_raises_typed(tmp_path):
    """What the JAX program refuses with ``--mesh2`` (a discipline other
    than the padded ones, factors whose product is under 2) is a usage
    error here too, before anything runs; ``-e all`` sweeps the same three."""
    jb = jax_benchmark()
    for bad in (["-e", "compact"], ["-e", "unbuffered"], ["--mesh2", "1", "1"],
                ["--mesh2", "0", "4"]):
        argv = ["-d", "8", "8", "8", "-r", "1", "-p", "cpu", "--mesh2", "2", "2", *bad,
                "-o", str(tmp_path / "x.json")]
        for program in (benchmark.main, jb.main):
            with pytest.raises(SystemExit) as e:
                program(argv)
            assert e.value.code == 2
    assert not (tmp_path / "x.json").exists()
    args = benchmark.parse_args(["-d", "8", "8", "8", "-r", "1", "-p", "cpu", "--mesh2", "2",
                                 "3", "-e", "all", "-o", "x"])
    assert args.shards == 6 and benchmark.PENCIL_EXCHANGES == (
        "buffered", "bufferedBF16", "bufferedFloat")


def test_bench_prints_one_line(capsys):
    line = bench.main(["--cpu", "--dim", "8", "--chain", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == json.loads(json.dumps(line))
    assert line["unit"] == "GFLOP/s" and line["platform"] == "cpu"
    assert jperf.validate_perf_report(line["perf"]) == []
    assert line["run_id"] == line["plan"]["run_id"] == line["perf"]["run_id"]
