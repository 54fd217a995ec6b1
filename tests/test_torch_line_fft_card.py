"""The line FFT (``ops/line_fft.py``, ``csrc/line_fft.cu``) on the card.

At the forms of the benchmark's cells (256^3 C2C: z and x both ways; 512^3
R2C: z, the C2R x backward and the R2C x forward), the kernel is held to its
plain version bitwise (both round every product and sum on its own, in one
order), and its error against a complex128 reference (``torch.fft`` in
complex128, a test's yardstick the port never calls) to be no worse than
that of the K1 form it replaces. At every length it takes, the kernel's
ragged edges (rows and z columns past a whole block), strided planes,
padding slots, both signs and a scale are held to the plain version bitwise.

Run on a machine with a CUDA card: ``python -m pytest -m card tests/``.
"""
import numpy as np
import pytest
import torch

from spfft_tpu_torch.obs import hlo
from spfft_tpu_torch.ops import complex_matmul as k1
from spfft_tpu_torch.ops import fft as offt
from spfft_tpu_torch.ops import line_fft as lf

pytestmark = pytest.mark.card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _slots(n, extent, num_slots, seed):
    """The x of each slot: the sphere's x (``extent`` of them about 0, mod
    ``n``; for a half spectrum ``0..extent-1``), in a shuffled slot order."""
    rng = np.random.default_rng(seed)
    half = extent // 2
    xs = (np.arange(extent) if n < 0 else np.arange(-half, extent - half) % n)
    return rng.permutation(xs), num_slots


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _pair(gen, *shape):
    return tuple(torch.randn(shape, generator=gen, device="cuda") for _ in range(2))


def _const(w):
    return k1.Constant(*(torch.from_numpy(np.ascontiguousarray(p)).cuda() for p in w))


# (name, kind, N, rows or (Y, Z), x extent, slots): the cells' forms
CELL_FORMS = [
    ("256-z", "rows", 256, 22381, None, None),
    ("256-x", "c2c", 256, (256, 256), 169, 176),
    ("512-z", "rows", 512, 44907, None, None),
    ("512-x", "r2c", 512, (512, 512), 169, 176),
]


def _z_form(gen, n, rows, sign):
    xr, xi = _pair(gen, rows, n)
    x = torch.complex(xr.double(), xi.double())
    ref = torch.fft.ifft(x, dim=1, norm="forward") if sign > 0 else torch.fft.fft(x, dim=1)
    w = _const(offt.matrix_pair(offt.c2c_matrix(n, sign), np.float32))
    k1_out = offt.complex_matmul(xr, xi, *w.pair, "sz,zk->sk", constant=w)
    lines = lf.Lines(n, "cuda")
    got = lf.rows(xr, xi, lines, sign)
    plain = lf.rows_plain(xr, xi, lines, sign)
    return got, plain, k1_out, ref


@pytest.mark.parametrize("name,kind,n,shape,extent,slots", CELL_FORMS)
def test_the_cells_forms_match_the_plain_version_and_beat_k1(cuda, name, kind, n, shape,
                                                             extent, slots):
    gen = torch.Generator(device="cuda").manual_seed(20231)
    errors = {}
    if kind == "rows":
        for sign in (1, -1):
            got, plain, k1_out, ref = _z_form(gen, n, shape, sign)
            torch.cuda.synchronize()
            assert all(torch.equal(g, p) for g, p in zip(got, plain))
            errors[f"z{sign:+d}"] = (_rel(torch.complex(*got).to(ref.dtype), ref),
                                     _rel(torch.complex(*k1_out).to(ref.dtype), ref))
    else:
        r2c = kind == "r2c"
        Y, Z = shape
        ux, A = _slots(-1 if r2c else n, extent, slots, seed=n)
        lines = lf.Lines(n, "cuda", ux, A)
        wx_b, wx_f = offt.x_stage_matrices(n, ux, A, r2c, np.float32)
        wb, wf = _const(wx_b), _const(wx_f)
        uxl = torch.as_tensor(np.asarray(ux), device="cuda")
        # backward: the grid's slots at their x, a full inverse transform
        gre, gim = _pair(gen, Y, A, Z)
        g = torch.zeros((Y, n, Z), dtype=torch.complex128, device="cuda")
        g[:, uxl] = torch.complex(gre, gim).to(torch.complex128)[:, :ux.size]
        if r2c:
            c = lf.hermitian_weights(n, "cuda").double()
            want = torch.fft.ifft(g * c[None, :, None], dim=1, norm="forward").real
            got = lf.to_space(gre, gim, lines, real_out=True)
            plain = lf.to_space_plain(gre, gim, lines, real_out=True)
            k1_out = offt.real_out_matmul(gre, gim, *wb.pair, "kxz,xl->klz", constant=wb)
            torch.cuda.synchronize()
            assert torch.equal(got, plain)
            errors["x_backward"] = (_rel(got.double(), want), _rel(k1_out.double(), want))
        else:
            want = torch.fft.ifft(g, dim=1, norm="forward")
            got = lf.to_space(gre, gim, lines, real_out=False)
            plain = lf.to_space_plain(gre, gim, lines, real_out=False)
            k1_out = offt.complex_matmul(gre, gim, *wb.pair, "kxz,xl->klz", constant=wb)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, plain))
            errors["x_backward"] = (_rel(torch.complex(*got).to(want.dtype), want),
                                    _rel(torch.complex(*k1_out).to(want.dtype), want))
        del g, got, plain, k1_out, want
        # forward: the space's lines transformed, each slot its x
        sre = torch.randn((Y, n, Z), generator=gen, device="cuda")
        sim = None if r2c else torch.randn((Y, n, Z), generator=gen, device="cuda")
        s = sre.double() if r2c else torch.complex(sre, sim).to(torch.complex128)
        full = torch.fft.fft(s, dim=1)
        want = torch.zeros((Y, A, Z), dtype=torch.complex128, device="cuda")
        want[:, :ux.size] = full[:, uxl]
        del full, s
        got = lf.from_space(sre, sim, lines)
        plain = lf.from_space_plain(sre, sim, lines)
        if r2c:
            k1_out = offt.real_in_matmul(sre, *wf.pair, "yxz,xk->ykz", constant=wf)
        else:
            k1_out = offt.complex_matmul(sre, sim, *wf.pair, "yxz,xk->ykz", constant=wf)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
        errors["x_forward"] = (_rel(torch.complex(*got).to(want.dtype), want),
                               _rel(torch.complex(*k1_out).to(want.dtype), want))
    print(name, {k: f"fft {a:.3e}, k1 {b:.3e}" for k, (a, b) in errors.items()})
    for what, (fft_err, k1_err) in errors.items():
        assert fft_err <= k1_err, f"{name} {what}: {fft_err} against K1's {k1_err}"


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024])
def test_ragged_strided_and_padded_forms_are_bitwise_the_plain_version(cuda, n):
    gen = torch.Generator(device="cuda").manual_seed(n)
    lines_per_block = 4096 // n
    rows = 3 * lines_per_block + 5  # a ragged last block
    before = sum(lf.launches.values())
    with hlo.recording() as rec:
        for sign, scale in ((1, 1.0), (-1, 1.0 / 3.0)):
            wide = torch.randn((2, rows, n + 7), generator=gen, device="cuda")
            xr, xi = wide[0, :, 3:3 + n], wide[1, :, 3:3 + n]  # row stride n + 7
            lines = lf.Lines(n, "cuda")
            got = lf.rows(xr, xi, lines, sign, scale)
            want = lf.rows_plain(xr, xi, lines, sign, scale)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        Y, Z = 3, lines_per_block + 3  # ragged z columns
        extent = n // 2 + 1
        for real in (False, True):
            ux, A = _slots(-1 if real else n, extent - 4, extent + 2, seed=n)
            lines = lf.Lines(n, "cuda", ux, A)
            grid = torch.randn((2, Y, A + 1, Z), generator=gen, device="cuda")[:, :, 1:]
            got = lf.to_space(grid[0], grid[1], lines, real_out=real)
            want = lf.to_space_plain(grid[0], grid[1], lines, real_out=real)
            assert (torch.equal(got, want) if real
                    else all(torch.equal(g, w) for g, w in zip(got, want)))
            space = torch.randn((2, Y, n, Z), generator=gen, device="cuda")
            sim = None if real else space[1]
            got = lf.from_space(space[0], sim, lines)
            want = lf.from_space_plain(space[0], sim, lines)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert not got[0][:, ux.size:].any()  # padding slots are zero
    torch.cuda.synchronize()
    assert sum(lf.launches.values()) - before == 6
    assert [op for op, _, _ in rec.ops].count(hlo.FFT) == 6


def test_a_refused_operand_raises(cuda):
    lines = lf.Lines(256, "cuda")
    x = torch.zeros((4, 256), device="cuda")
    with pytest.raises(Exception):
        lf.rows(x.double(), x.double(), lines, 1)
    with pytest.raises(Exception):
        lf.rows(x.t().contiguous().t(), x, lines, 1)
    with pytest.raises(Exception):
        lf.to_space(x[None], x[None], lines, real_out=False)  # no slot maps
