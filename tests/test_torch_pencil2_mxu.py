"""The port's matrix-product pencil engine (``engine="mxu"``, K1 and K2)
against the JAX package's ``xla`` pencil engine, which computes the same
function (the JAX MXU pencil engine cannot be imported on this jax). Cases,
helpers and tolerances as ``tests/test_torch_pencil2.py``: 1e-11 in
float64, 1e-5 in float32, the wire casts' bars against JAX's same
discipline."""
import numpy as np
import pytest
import torch

import spfft_tpu_torch as tp
from spfft_tpu_torch.ops import fft as offt
from spfft_tpu_torch.parallel import ragged
from test_torch_pencil2 import (EXPLICIT, TOL, against_jax, check_against, jax_plan, port_plan,
                                problem)


@pytest.mark.parametrize("p1,p2", [(2, 4), (4, 2), (1, 8), (8, 1), (2, 2)])
def test_mesh_shapes_c2c_match_jax(p1, p2, monkeypatch):
    per, vals = problem(False, p1 * p2, 41 + p1)
    against_jax(False, p1, p2, per, vals, np.float64, tp.ExchangeType.DEFAULT, "mxu",
                monkeypatch)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("p1,p2", [(2, 2), (4, 2)])
def test_r2c_matches_jax(p1, p2, dtype, monkeypatch):
    per, vals = problem(True, p1 * p2, 7 + p1)
    against_jax(True, p1, p2, per, vals, dtype, tp.ExchangeType.DEFAULT, "mxu", monkeypatch)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_c2c_float32_and_float64(dtype, monkeypatch):
    per, vals = problem(False, 6, 19, layout=(2, 3))
    against_jax(False, 2, 3, per, vals, dtype, tp.ExchangeType.DEFAULT, "mxu", monkeypatch)


def test_beyond_slab_limit():
    dims = (8, 8, 2)
    per, vals = problem(False, 8, 43, dims=dims, radius=0.7)
    port = port_plan(False, 4, 2, per, exchange=tp.ExchangeType.BUFFERED, engine="mxu",
                     dims=dims)
    ref = jax_plan(False, 4, 2, per, np.float64, tp.ExchangeType.BUFFERED, dims)
    check_against(ref, port, vals, TOL[np.float64])


def test_imbalanced_sticks_and_partial_r2c():
    per, vals = problem(False, 4, 13, weights=(5, 1, 1, 1))
    port = port_plan(False, 2, 2, per, exchange=tp.ExchangeType.UNBUFFERED, engine="mxu")
    check_against(jax_plan(False, 2, 2, per, np.float64, tp.ExchangeType.UNBUFFERED), port,
                  vals, TOL[np.float64])
    per, vals = problem(True, 4, 14, radius=0.5)
    port = port_plan(True, 2, 2, per, exchange=tp.ExchangeType.BUFFERED, engine="mxu")
    check_against(jax_plan(True, 2, 2, per, np.float64, tp.ExchangeType.BUFFERED), port, vals,
                  TOL[np.float64])


@pytest.mark.parametrize("exchange", EXPLICIT, ids=lambda e: e.name)
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_every_discipline_matches_jax(r2c, exchange, monkeypatch):
    per, vals = problem(r2c, 6, 3 + int(exchange), layout=(3, 2))
    against_jax(r2c, 3, 2, per, vals, np.float64, exchange, "mxu", monkeypatch)


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_one_k1_per_stage_and_one_k2_per_exchange(r2c, monkeypatch):
    """A staged pair runs 6 K1 launches (z, y, x each way), each over every
    stacked shard at the shapes of the module docstring, and 4 K2 gathers
    (exchanges A and B each way); fused equals staged bitwise."""
    per, vals = problem(r2c, 4, 23)
    t = port_plan(r2c, 2, 2, per, exchange=tp.ExchangeType.BUFFERED, engine="mxu", fuse=False)
    ex, p = t._exec, t.params
    calls = {"k1": [], "k2": []}
    k1, k2 = offt._k1, ragged.row_gather
    monkeypatch.setattr(offt, "_k1", lambda *a, **kw: calls["k1"].append(
        (a[0].shape, a[2].shape)) or k1(*a, **kw))
    monkeypatch.setattr(ragged, "row_gather", lambda *a, **kw: calls["k2"].append(
        (a[0].shape, a[2].shape)) or k2(*a, **kw))
    space = t.backward(vals)
    back = t.forward(scaling=tp.ScalingType.FULL)
    assert len(calls["k1"]) == 6 and len(calls["k2"]) == 4
    S, Z, Y, X = p.max_num_sticks, p.dim_z, p.dim_y, p.dim_x
    Ax, Lz, Ly, P1, P2 = ex._Ax, ex._Lz, ex._Ly, ex.P1, ex.P2
    assert calls["k1"][0] == ((1, 4 * S, Z), (1, Z, P2 * Lz))  # z backward
    assert calls["k1"][1] == ((1, Y, Y), (1, Y, 4 * Ax * Lz))  # y over the stacked grid
    assert calls["k1"][2][0] == (4 * Ly, X, P1 * Ax)  # x: W^T per (shard, y-row)
    assert calls["k2"][0] == ((4 * S * P2, Lz), (Y * 4 * Ax,))
    assert calls["k2"][1] == ((Y * 4 * Ax, Lz), (4 * Ly * P1 * Ax,))
    fused = port_plan(r2c, 2, 2, per, exchange=tp.ExchangeType.BUFFERED, engine="mxu")
    monkeypatch.undo()
    assert torch.equal(fused.backward(vals), space)
    for a, b in zip(fused.forward(scaling=tp.ScalingType.FULL), back):
        assert torch.equal(a, b)


def test_describe_and_card():
    per, _ = problem(False, 4, 2)
    t = port_plan(False, 2, 2, per, engine="mxu", precision="high")
    d = t.describe()
    assert d["engine"] == "pencil2-mxu" and d["matmul_precision"] == "HIGH"
    assert d["pencil_geometry"]["p1"] == 2 and d["exchange"]["rounds"] == 2
    assert d["ir"]["stages"]["backward"] == ["compression", "z transform", "exchange A",
                                             "y transform", "exchange B", "x transform"]
    assert t.report()["engine"] == "pencil2-mxu"
    c = t.clone()
    assert c.engine == "pencil2-mxu" and c.exchange_type == t.exchange_type
