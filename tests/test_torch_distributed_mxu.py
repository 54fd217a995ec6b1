"""The port's MXU mesh engine (K1/K2 in their plain versions on the CPU)
against the JAX package's DistributedTransform(engine="xla"), which computes
the same function (the JAX MXU mesh engine cannot be imported on this jax),
and against the port's own local Transform.

Each y plan (dense, per-slot, blocked) is planned from the global sticks;
the plan and its buckets must be what the JAX planner
(``spfft_tpu/ops/fft.py`` ``plan_sparse_y``, ``plan_sparse_y_blocked``) makes
of the same global stick arrays. Tolerances, max abs diff over max |ref|:
1e-11 in float64 (matrix DFTs against FFTs), 1e-5 in float32.
"""
import numpy as np
import pytest

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu.ops import fft as jfft
from test_torch_distributed import check_against, jax_plan, port_plan, problem

TOL = {np.float64: 1e-11, np.float32: 1e-5}
BLOCKS = "SPFFT_TPU_SPARSE_Y_BLOCKS"
# (name, dims, radius, r2c, knobs, y plan, buckets, exchange)
PLANS = [
    ("per-slot", (24, 24, 8), 0.3, False, {}, "per-slot", None, tp.ExchangeType.UNBUFFERED),
    ("blocked auto", (24, 24, 8), 0.6, False, {}, "blocked", 4, tp.ExchangeType.BUFFERED),
    ("blocked G=2", (24, 24, 8), 0.6, False, {BLOCKS: "2"}, "blocked", 2,
     tp.ExchangeType.COMPACT_BUFFERED),
    ("r2c blocked G=2", (24, 24, 8), 0.6, True, {BLOCKS: "2"}, "blocked", 3,
     tp.ExchangeType.UNBUFFERED),
    ("dense, full x extent", (16, 24, 8), 0.6, False, {}, "dense", None,
     tp.ExchangeType.BUFFERED),
    ("r2c dense", (24, 24, 8), 0.6, True, {BLOCKS: "0"}, "dense", None, tp.ExchangeType.DEFAULT),
]


def jax_y_plan(params, dtype):
    """What the JAX mesh engine plans (spfft_tpu/parallel/execution_mxu.py:287-400)
    from the global stick arrays: ("per-slot", Sy, row_of) or ("blocked",
    bucket rows, row_of) or ("dense",)."""
    Xf, Y = params.dim_x_freq, params.dim_y
    sx = params.stick_x_all.reshape(-1).astype(np.int64)
    valid = sx < Xf
    ux = np.unique(sx[valid])
    A = jfft.compact_x_extent(ux.size, Xf)
    xslot_of = np.arange(Xf) if A == Xf else np.zeros(Xf, dtype=np.int64)
    if A < Xf:
        xslot_of[ux] = np.arange(ux.size)
    xslot = xslot_of[sx[valid]]
    ys = params.stick_y_all.reshape(-1).astype(np.int64)[valid]
    r2c = params.transform_type == tp.TransformType.R2C
    if not r2c:
        sy = jfft.plan_sparse_y(xslot, ys, A, Y, dtype)
        if sy is not None:
            return ("per-slot", sy[0], sy[1])
    if A < Xf:
        blk = jfft.plan_sparse_y_blocked(xslot, ys, Y, dtype, int(valid.sum()), A * Y,
                                         dense_slots=(0,) if r2c and (sx[valid] == 0).any() else ())
        if blk is not None:
            return ("blocked", [r for r, _, _ in blk["buckets"]], blk["row_of_stick"])
    return ("dense",)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name,dims,radius,r2c,env,y_plan,buckets,exchange", PLANS,
                         ids=[p[0] for p in PLANS])
def test_mxu_mesh_engine_matches_jax(name, dims, radius, r2c, env, y_plan, buckets, exchange,
                                     dtype, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    per, vals = problem(r2c, 4, len(name), dims=dims, weights=(2, 1, 1, 1), radius=radius)
    lz = (dims[2] - 3 * (dims[2] // 4),) + (dims[2] // 4,) * 3
    port = port_plan(r2c, 4, per, dtype, exchange, lz, dims=dims, engine="mxu")
    ex = port._exec
    assert port.engine == "mxu" and ex.y_plan == y_plan
    want = jax_y_plan(port.params, dtype)
    assert want[0] == y_plan
    if y_plan == "per-slot":
        assert ex.sy == want[1]
    if y_plan == "blocked":
        assert [(ag, syg) for ag, syg, _, _ in ex.buckets] == [r.shape for r in want[1]]
        assert len(ex.buckets) == buckets
        np.testing.assert_array_equal(ex._bucket_rows_np, np.concatenate(
            [r.reshape(-1) for r in want[1]]))
    ref = jax_plan(r2c, 4, per, dtype, port.exchange_type, lz, dims=dims)
    check_against(ref, port, vals, TOL[dtype])

    # the port's local plan of the same triplets
    local = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=np.concatenate(per),
                         dtype=dtype, engine="mxu")
    space = port.backward(vals).numpy()
    want_space = local.backward(np.concatenate(vals)).numpy()
    assert np.abs(space - want_space).max() <= TOL[dtype] * np.abs(want_space).max()


@pytest.mark.parametrize("P", [1, 2])
def test_mxu_mesh_engine_small_meshes(P):
    per, vals = problem(False, P, P, dims=(24, 24, 8), radius=0.6)
    port = port_plan(False, P, per, np.float64, dims=(24, 24, 8), engine="mxu")
    ref = jax_plan(False, P, per, np.float64, port.exchange_type, dims=(24, 24, 8))
    check_against(ref, port, vals, TOL[np.float64])
    card = port.describe()
    assert card["sparse_y"]["variant"] == port._exec.y_plan
    assert card["padded_geometry"]["s_max"] == port.params.max_num_sticks


def test_float_wires_match_jax():
    per, vals = problem(True, 4, 2, dims=(24, 24, 8), radius=0.6)
    for exchange, tol in ((tp.ExchangeType.BUFFERED_FLOAT, 1e-6),
                          (tp.ExchangeType.COMPACT_BUFFERED_BF16, 3e-2)):
        port = port_plan(True, 4, per, np.float64, exchange, dims=(24, 24, 8), engine="mxu")
        ref = jax_plan(True, 4, per, np.float64, exchange, dims=(24, 24, 8))
        check_against(ref, port, vals, tol)
        assert spfft_tpu.ExchangeType(int(port.exchange_type)) == ref.exchange_type
