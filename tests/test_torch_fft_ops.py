"""spfft_tpu_torch DFT-stage operators: the DFT-matrix functions against
spfft_tpu.ops.fft, K1's plain version against the Pallas kernel (interpret
mode) and numpy. K2's tests are in ``test_torch_row_gather.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spfft_tpu_torch.errors as terr
from spfft_tpu.ops import fft as jfft
from spfft_tpu.ops import pallas_fft
from spfft_tpu.types import ScalingType as JScaling
from spfft_tpu_torch.ops import complex_matmul as k1
from spfft_tpu_torch.ops import fft as tfft

MATRIX_ATOL = 1e-13


@pytest.mark.parametrize("n,sign,scale,perm,rows", [
    (8, +1, 1.0, None, None), (9, -1, 0.25, None, None),
    (12, +1, 1.0, [3, 0, 7, -1, 11], 8), (7, -1, 1.0, [6, 2], None),
])
def test_c2c_matrix_matches(n, sign, scale, perm, rows):
    a = jfft.c2c_matrix(n, sign, scale=scale, row_perm=perm, num_rows=rows)
    b = tfft.c2c_matrix(n, sign, scale=scale, row_perm=perm, num_rows=rows)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=MATRIX_ATOL)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 16])
def test_real_matrices_match(n):
    for jf, tf in ((jfft.r2c_matrices, tfft.r2c_matrices), (jfft.c2r_matrices, tfft.c2r_matrices)):
        for a, b in zip(jf(n, 0.5), tf(n, 0.5)):
            np.testing.assert_allclose(b, a, rtol=0, atol=MATRIX_ATOL)


@pytest.mark.parametrize("dims", [(8, 8, 8), (11, 9, 13)])
def test_zy_stage_matrices_match(dims):
    dz, dy = dims[2], dims[1]
    total = dims[0] * dy * dz
    ja = jfft.zy_stage_matrices(dz, dy, total, np.float64)
    ta = tfft.zy_stage_matrices(dz, dy, total, np.float64)
    for jp, tpair in zip(ja[:3], ta[:3]):
        for a, b in zip(jp, tpair):
            np.testing.assert_allclose(b, a, rtol=0, atol=MATRIX_ATOL)
    for s in (JScaling.NONE, JScaling.FULL):
        for a, b in zip(ja[3][s], ta[3][int(s)]):
            np.testing.assert_allclose(b, a, rtol=0, atol=MATRIX_ATOL)


@pytest.mark.parametrize("num_unique,dim_x_freq", [(1, 16), (7, 16), (8, 16), (9, 16), (15, 12), (0, 5)])
def test_compact_x_extent_matches(num_unique, dim_x_freq):
    assert tfft.compact_x_extent(num_unique, dim_x_freq) == jfft.compact_x_extent(
        num_unique, dim_x_freq
    )


@pytest.mark.parametrize("r2c", [False, True])
def test_x_stage_matrices_match(r2c):
    dim_x = 12
    ux = np.array([0, 2, 3, 5, -1, 6])
    rows = 8
    ja = jfft.x_stage_matrices(dim_x, ux, rows, r2c, np.float64)
    ta = tfft.x_stage_matrices(dim_x, ux, rows, r2c, np.float64)
    for jp, tpair in zip(ja, ta):
        for a, b in zip(jp, tpair):
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=0, atol=MATRIX_ATOL)


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (64, 256, 128), (40, 128, 256)])
def test_k1_plain_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(7)
    xr, xi = (rng.standard_normal((m, k)).astype(np.float32) for _ in range(2))
    wr, wi = (rng.standard_normal((k, n)).astype(np.float32) for _ in range(2))
    yr, yi = pallas_fft.complex_matmul_fused(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(wr), jnp.asarray(wi), interpret=True
    )
    t = lambda a: torch.from_numpy(a)[None]
    cr, ci = k1.complex_matmul_plain(t(xr), t(xi), t(wr), t(wi))
    np.testing.assert_allclose(cr[0].numpy(), np.asarray(yr), atol=1e-3)
    np.testing.assert_allclose(ci[0].numpy(), np.asarray(yi), atol=1e-3)


# (spec, data shape, matrix shape) of every stage of the engine
STAGES = [
    ("sz,zk->sk", (13, 9), (9, 9)),
    ("yxz,yk->kxz", (10, 6, 9), (10, 10)),
    ("ykz,yl->lkz", (10, 6, 9), (10, 10)),
    ("kxz,xl->klz", (10, 6, 9), (6, 11)),
    ("yxz,xk->ykz", (10, 11, 9), (11, 6)),
]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("form", ["complex", "real_in", "real_out"])
@pytest.mark.parametrize("spec,xshape,wshape", STAGES)
def test_stage_contraction_matches_numpy(spec, xshape, wshape, form):
    rng = np.random.default_rng(len(spec) + sum(xshape))
    x = rng.standard_normal(xshape) + 1j * rng.standard_normal(xshape)
    w = rng.standard_normal(wshape) + 1j * rng.standard_normal(wshape)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if form == "real_in":
        x = x.real
        yr, yi = tfft.real_in_matmul(t(x), t(w.real), t(w.imag), spec)
        got = yr.numpy() + 1j * yi.numpy()
        expected = np.einsum(spec, x, w)
    elif form == "real_out":
        got = tfft.real_out_matmul(t(x.real), t(x.imag), t(w.real), t(w.imag), spec).numpy()
        expected = np.einsum(spec, x, w).real
    else:
        yr, yi = tfft.complex_matmul(t(x.real), t(x.imag), t(w.real), t(w.imag), spec)
        got = yr.numpy() + 1j * yi.numpy()
        expected = np.einsum(spec, x, w)
    assert got.shape == expected.shape
    assert _rel(got, expected) <= 1e-12


def test_operands_are_views():
    x = torch.zeros(10, 6, 9, dtype=torch.float64)
    w = torch.zeros(6, 11, dtype=torch.float64)
    (ar, ai, br, bi), shape = tfft.operands("kxz,xl->klz", x, x, w, w)
    assert ar.stride(0) == 0 and ar.data_ptr() == w.data_ptr()
    assert br.data_ptr() == x.data_ptr() and shape == (10, 11, 9)
    with pytest.raises(terr.InvalidParameterError):
        tfft.operands("ab,bc->ac", x, x, w, w)


def test_k1_wrapper_on_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(3)
    a, ai, b, bi = (torch.from_numpy(rng.standard_normal(s)) for s in
                    ((2, 5, 4), (2, 5, 4), (2, 4, 3), (2, 4, 3)))
    before = sum(k1.launches.values())
    got = k1.complex_matmul(a, ai, b, bi)
    ref = k1.complex_matmul_plain(a, ai, b, bi)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert sum(k1.launches.values()) == before
    assert k1.complex_matmul(a, None, b, None, want_imag=False)[1] is None
    with pytest.raises(terr.InvalidParameterError):
        k1.complex_matmul(a, ai, b[:, :3], bi[:, :3])
    with pytest.raises(terr.InvalidParameterError):
        k1.complex_matmul(a, ai.float(), b, bi)
