"""K2, ``spfft_tpu_torch.ops.row_gather``, on the CPU (its plain version)
against the JAX package's own gather: ``jnp.take`` on the source with one zero
row appended, as ``spfft_tpu/execution_mxu.py`` ``_expand`` does, so that the
engine's sentinels -1 and ``n_src`` both read zeros; and every row against
the documented contract in numpy, which also covers indices past both
sentinels (-3, ``n_src + 3``), where ``jnp.take`` would wrap. Every width the CUDA
kernel's vector rule can meet (1, 3, 8, 33, 70 and the main path's 32, 64,
256, 512), float32 and float64, one plane and two, planes contiguous, at a
one-element column offset in wider buffers, and written into column blocks of
a wider ``out=``; one row and many. Results must be exactly equal. Then the
wrapper's refusals, on every device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spfft_tpu_torch.errors as terr
from spfft_tpu_torch.ops import row_gather as k2

WIDTHS = [1, 3, 8, 33, 70, 32, 64, 256, 512]
N_SRC = 37


def jax_gather(src, idx):
    """The JAX engine's expand: ``jnp.take`` of the zero-padded source."""
    zero = jnp.zeros((1, src.shape[1]), dtype=src.dtype)
    return np.asarray(jnp.take(jnp.concatenate([jnp.asarray(src), zero]), jnp.asarray(idx),
                               axis=0))


def contract(src, idx):
    """``src[idx[r]]`` where ``0 <= idx[r] < n_src``, else a zero row."""
    valid = (idx >= 0) & (idx < src.shape[0])
    return np.where(valid[:, None], src[np.clip(idx, 0, src.shape[0] - 1)], 0).astype(src.dtype)


@pytest.mark.parametrize("rows", [1, 40])
@pytest.mark.parametrize("layout", ["contiguous", "offset", "packed"])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", WIDTHS)
def test_row_gather_matches_jax_take(width, dtype, planes, layout, rows):
    rng = np.random.default_rng([width, planes, rows, np.dtype(dtype).itemsize])
    srcs = [rng.standard_normal((N_SRC, width)).astype(dtype) for _ in range(planes)]
    idx = rng.integers(-3, N_SRC + 4, size=rows).astype(np.int32)
    # both sentinels, a real row, and indices past each sentinel
    idx[:5] = [-1, N_SRC, N_SRC - 1, -3, N_SRC + 3][:rows]
    engine = (idx >= -1) & (idx <= N_SRC)  # the indices the JAX engine hands jnp.take
    want = [contract(s, idx) for s in srcs]

    if layout == "offset":  # planes and outputs one column into wider buffers
        held = [np.zeros((N_SRC, width + 1), dtype) for _ in srcs]
        for h, s in zip(held, srcs):
            h[:, 1:] = s
        src = [torch.from_numpy(h)[:, 1:] for h in held]
        dst = torch.full((planes, rows, width + 2), 7.0, dtype=src[0].dtype)
        out = [dst[q, :, 1:width + 1] for q in range(planes)]
        kept = [dst[..., :1], dst[..., width + 1:]]
    elif layout == "packed":  # plane q into column block q + 1, as the exchange packs
        src = [torch.from_numpy(s) for s in srcs]
        dst = torch.full((rows, (planes + 1) * width), 7.0, dtype=src[0].dtype)
        out = [dst[:, (q + 1) * width:(q + 2) * width] for q in range(planes)]
        kept = [dst[:, :width]]
    else:
        src, out, kept = [torch.from_numpy(s) for s in srcs], None, []
    second = lambda ts: ts[1] if planes > 1 else None
    got = k2.row_gather(src[0], second(src), torch.from_numpy(idx),
                        out=None if out is None else (out[0], second(out)))
    assert (got[1] is None) == (planes == 1)
    if out is not None:
        assert all(g is o for g, o in zip(got, out))
    for g, w, s in zip(got, want, srcs):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy()[engine], jax_gather(s, idx[engine]))
    for k in kept:
        assert bool((k == 7.0).all())


def _refusals():
    f = lambda *shape: torch.zeros(shape)
    i32 = lambda n: torch.zeros(n, dtype=torch.int32)
    wide = torch.zeros(12, 10)
    return {
        "2-D index": lambda: k2.row_gather(f(4, 3), None, torch.zeros(2, 2, dtype=torch.int32)),
        "planes of two widths": lambda: k2.row_gather(f(4, 3), f(4, 2), i32(2)),
        "planes of two dtypes": lambda: k2.row_gather(f(4, 3), f(4, 3).double(), i32(2)),
        "out= of other rows": lambda: k2.row_gather(f(9, 5), None, i32(12), out=(f(11, 5), None)),
        "out= of another dtype": lambda: k2.row_gather(f(9, 5), None, i32(12),
                                                       out=(f(12, 5).double(), None)),
        "out= one plane short": lambda: k2.row_gather(f(9, 5), f(9, 5), i32(12),
                                                      out=(f(12, 5), None)),
        "out= planes of two row strides": lambda: k2.row_gather(
            f(9, 5), f(9, 5), i32(12), out=(wide[:, :5], f(12, 5))),
        "out= not row-strided": lambda: k2.row_gather(f(9, 5), None, i32(12),
                                                      out=(f(5, 12).mT, None)),
        "int64 index": lambda: k2.row_gather(f(4, 3), None, torch.zeros(2, dtype=torch.int64)),
        "non-contiguous index": lambda: k2.row_gather(f(4, 3), None, i32(8)[::2]),
        "planes of two row strides": lambda: k2.row_gather(wide[:9, :5], f(9, 5), i32(12)),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_row_gather_refuses(case):
    with pytest.raises(terr.InvalidParameterError):
        _refusals()[case]()


def test_row_gather_on_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.standard_normal((9, 4)))
    idx = torch.from_numpy(np.array([8, -1, 9, 0], dtype=np.int32))
    before = sum(k2.launches.values())
    got, _ = k2.row_gather(src, None, idx)
    assert torch.equal(got, k2.row_gather_plain(src, idx))
    assert sum(k2.launches.values()) == before
