#!/usr/bin/env python3
"""Drives spfft_tpu_torch on one CUDA card and holds every kernel to its plain version.

Run from the root of a checkout, on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. each kernel (K1 ``complex_matmul``, K2 ``row_gather``) at the shapes the
   main path gives it, against its plain PyTorch version on the same inputs,
   with its time, the plain version's time, one PyTorch library call's time
   and the least time the card could take (``bound_ms``); K1 once more in f64;
3. the main path at full width: ``Transform(ProcessingUnit.GPU, ...)`` at
   256^3 with the spherical cutoff 0.659, C2C and R2C in float32, backward then
   forward(FULL), against a complex128 dense oracle on the host, with the
   kernels' launch counts from that run and the median ms per pair;
4. the ``kernels`` line; last, the ``{"ok": true, "device": ...}`` line.

Exits non-zero, with no result line, when there is no CUDA device or any
check fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

DIMS = (256, 256, 256)
RADIUS = 0.659
SEED = 1234
K1_RTOL = 1e-5  # kernel vs plain, max abs diff over max |plain|, float32
K1_F64_RTOL = 1e-12
ORACLE_RTOL = 1e-5
# H100 SXM published peaks (NVIDIA data sheet, 700 W): FP32 and FP64 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def k1_forms(plans):
    """Every K1 form the main path launches: (name, plan kind, spec, x, w, want_imag)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    forms = []
    for kind, t in plans.items():
        ex = t._exec
        p = t.params
        S, A, Y, X, Z = p.num_sticks, ex.num_x_active, p.dim_y, p.dim_x, p.dim_z
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        pair = lambda *shape: (rnd(*shape), rnd(*shape))
        forms.append((f"{kind}/z", kind, "sz,zk->sk", pair(S, Z), ex._wz_b, True))
        forms.append((f"{kind}/y", kind, "yxz,yk->kxz", pair(Y, A, Z), ex._wy_b, True))
        if kind == "c2c":
            forms.append((f"{kind}/x_backward", kind, "kxz,xl->klz", pair(Y, A, Z), ex._wx_b, True))
            forms.append((f"{kind}/x_forward", kind, "yxz,xk->ykz", pair(Y, X, Z), ex._wx_f, True))
        else:
            forms.append((f"{kind}/x_backward_real_out", kind, "kxz,xl->klz", pair(Y, A, Z),
                          ex._wx_b, False))
            forms.append((f"{kind}/x_forward_real_in", kind, "yxz,xk->ykz", (rnd(Y, X, Z), None),
                          ex._wx_f, True))
    return forms


def k1_key(ops, want_imag):
    ar, ai, br, bi = ops
    return (ar.shape[0], ar.shape[1], ar.shape[2], br.shape[2], ai is not None,
            bi is not None, want_imag)


def k1_bound_ms(ops, want_imag) -> tuple[float, str]:
    ar, ai, br, bi = ops
    batch, m, k = ar.shape
    n = br.shape[2]
    products = 4 if (ai is not None and bi is not None and want_imag) else 2
    flops = 2 * products * batch * m * n * k
    item = ar.element_size()
    a_mats = batch if ar.stride(0) else 1
    nbytes = item * (
        (1 + (ai is not None)) * a_mats * m * k
        + (1 + (bi is not None)) * batch * k * n
        + (1 + want_imag) * batch * m * n
    )
    t_ops = flops / PEAK_FLOPS[str(ar.dtype).split(".")[1]]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def run_k1(name, spec, x, w, want_imag):
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import fft as offt

    ops, _ = offt.operands(spec, x[0], x[1], w[0], w[1])
    cr, ci = k1.complex_matmul(*ops, want_imag)
    pr, pi = k1.complex_matmul_plain(*ops, want_imag)
    torch.cuda.synchronize()
    err = (cr - pr).abs().max().item()
    scale = pr.abs().max().item()
    if want_imag:
        err = max(err, (ci - pi).abs().max().item())
        scale = max(scale, pi.abs().max().item())
    ar, ai, br, bi = ops
    a_c = torch.complex(ar[:1] if ar.stride(0) == 0 else ar, ai[:1] if ai.stride(0) == 0 else ai)
    b_c = torch.complex(br, bi if bi is not None else torch.zeros_like(br))
    lib = (lambda: torch.matmul(a_c, b_c)) if want_imag else (lambda: torch.matmul(a_c, b_c).real)
    bound, bound_by = k1_bound_ms(ops, want_imag)
    row = {
        "name": f"complex_matmul:{name}", "route": "cuda",
        "source": "spfft_tpu_torch/csrc/complex_matmul.cu",
        "replaces": "spfft_tpu/ops/pallas_fft.py:95",
        "shape": {"batch": ar.shape[0], "M": ar.shape[1], "K": ar.shape[2], "N": br.shape[2]},
        "max_abs_err": err, "rel_err": err / scale,
        "ms": timed_ms(lambda: k1.complex_matmul(*ops, want_imag)),
        "plain_ms": timed_ms(lambda: k1.complex_matmul_plain(*ops, want_imag)),
        "library_ms": timed_ms(lib),
        "bound_ms": bound, "bound_by": bound_by,
    }
    emit({"phase": "kernel", **row})
    check(err <= K1_RTOL * scale, f"{row['name']} differs from its plain version: {err} vs {scale}")
    return row, k1_key(ops, want_imag)


def run_k2(name, src, idx):
    import torch
    from spfft_tpu_torch.ops import row_gather as k2

    ore, oim = k2.row_gather(src[0], src[1], idx)
    pre, pim = k2.row_gather_plain(src[0], idx), k2.row_gather_plain(src[1], idx)
    torch.cuda.synchronize()
    exact = torch.equal(ore, pre) and torch.equal(oim, pim)
    err = max((ore - pre).abs().max().item(), (oim - pim).abs().max().item())
    n_src, width = src[0].shape
    il = idx.long()
    valid = (il >= 0) & (il < n_src)
    both = torch.stack([torch.cat([s, s.new_zeros((1, width))]) for s in src])
    il = torch.where(valid, il, torch.full_like(il, n_src))
    item = src[0].element_size()
    rows_read = torch.unique(il[valid]).numel()
    nbytes = 2 * item * width * (rows_read + idx.numel()) + idx.element_size() * idx.numel()
    row = {
        "name": f"row_gather:{name}", "route": "cuda",
        "source": "spfft_tpu_torch/csrc/row_gather.cu",
        "replaces": "programs/microbench_pallas_dma.py:140",
        "shape": {"rows": idx.numel(), "n_src": n_src, "width": width, "planes": 2},
        "max_abs_err": err, "bitwise_equal": exact,
        "ms": timed_ms(lambda: k2.row_gather(src[0], src[1], idx)),
        "plain_ms": timed_ms(lambda: (k2.row_gather_plain(src[0], idx),
                                      k2.row_gather_plain(src[1], idx))),
        "library_ms": timed_ms(lambda: torch.index_select(both, 1, il)),
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
    }
    emit({"phase": "kernel", **row})
    check(exact, f"{row['name']} is not bitwise equal to its plain version")
    return row, (idx.numel(), n_src, width, 2)


def storage(idx, dim):
    return np.where(idx < 0, idx + dim, idx)


def main_path(sp, kind, t, triplets, full_triplets):
    """One backward + forward(FULL) through the entry points, checked against a
    dense complex128 oracle; returns the launch counts of that run."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import row_gather as k2

    Z, Y, X = DIMS[2], DIMS[1], DIMS[0]
    N = X * Y * Z
    rng = np.random.default_rng(SEED)
    if kind == "c2c":
        values = rng.standard_normal(len(triplets)) + 1j * rng.standard_normal(len(triplets))
        dense = np.zeros((Z, Y, X), np.complex128)
        t3 = np.asarray(triplets)
        dense[storage(t3[:, 2], Z), storage(t3[:, 1], Y), storage(t3[:, 0], X)] = values
        oracle = np.fft.ifftn(dense) * N
    else:
        # hermitian-consistent values: the spectrum of a real field, cut to the
        # sphere (symmetric under k -> -k, no Nyquist plane at this radius)
        spectrum = np.fft.fftn(rng.standard_normal((Z, Y, X)))
        tf = np.asarray(full_triplets)
        zf, yf, xf = storage(tf[:, 2], Z), storage(tf[:, 1], Y), storage(tf[:, 0], X)
        dense = np.zeros((Z, Y, X), np.complex128)
        dense[zf, yf, xf] = spectrum[zf, yf, xf]
        oracle = (np.fft.ifftn(dense) * N).real
        th = np.asarray(triplets)
        values = spectrum[storage(th[:, 2], Z), storage(th[:, 1], Y), th[:, 0]]
        del spectrum
    del dense
    values_dev = torch.as_tensor(values.astype(np.complex64), device="cuda")

    k1.launches.clear()
    k2.launches.clear()
    space = t.backward(values_dev)
    back = t.forward(scaling=sp.ScalingType.FULL)
    torch.cuda.synchronize()
    counts = {"complex_matmul": dict(k1.launches), "row_gather": dict(k2.launches)}

    space_h = space.cpu().numpy()
    check(space_h.shape == (Z, Y, X) and np.isfinite(space_h).all(), f"{kind} space shape/finite")
    back_h = back.cpu().numpy()
    check(back_h.shape == (len(triplets),) and np.isfinite(back_h).all(), f"{kind} values shape/finite")
    oracle_err = float(np.abs(space_h - oracle).max() / np.abs(oracle).max())
    rt_err = float(np.abs(back_h - values).max() / np.abs(values).max())
    n_k1 = sum(counts["complex_matmul"].values())
    n_k2 = sum(counts["row_gather"].values())

    pair_ms = []
    for i in range(12):
        t0 = time.perf_counter()
        t.backward(values_dev)
        t.forward(scaling=sp.ScalingType.FULL)
        torch.cuda.synchronize()
        if i >= 2:
            pair_ms.append(1e3 * (time.perf_counter() - t0))
    emit({
        "phase": "main_path", "transform": kind, "dims": list(DIMS), "radius": RADIUS,
        "dtype": "float32", "num_values": len(triplets), "num_sticks": t.params.num_sticks,
        "num_x_active": t.num_x_active, "oracle_rel_err": oracle_err, "roundtrip_rel_err": rt_err,
        "launches": {"complex_matmul": n_k1, "row_gather": n_k2},
        "pair_ms_median": statistics.median(pair_ms), "pair_ms": pair_ms,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })
    check(oracle_err <= ORACLE_RTOL, f"{kind} backward vs dense oracle: {oracle_err}")
    check(rt_err <= ORACLE_RTOL, f"{kind} round trip: {rt_err}")
    check(n_k1 == 6 and n_k2 == 2, f"{kind} launches: {n_k1} K1, {n_k2} K2 (expected 6 and 2)")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import _build
    from spfft_tpu_torch.ops import complex_matmul as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    _build.build_all(["complex_matmul", "row_gather"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    triplets = {
        "c2c": sp.create_spherical_cutoff_triplets(*DIMS, RADIUS),
        "r2c": sp.create_spherical_cutoff_triplets(*DIMS, RADIUS, hermitian_symmetry=True),
    }
    plans = {
        kind: sp.Transform(sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()),
                           *DIMS, indices=trip, dtype=np.float32)
        for kind, trip in triplets.items()
    }
    emit({"phase": "plan", "seconds": time.perf_counter() - t0,
          **{f"{k}_sticks": t.params.num_sticks for k, t in plans.items()},
          **{f"{k}_x_active": t.num_x_active for k, t in plans.items()}})

    # ---- kernels against their plain versions, at the main path's shapes ----
    rows = []  # (row, kind, launch-count key)
    for name, kind, spec, x, w, want_imag in k1_forms(plans):
        row, key = run_k1(name, spec, x, w, want_imag)
        rows.append((row, kind, "complex_matmul", key))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for kind, t in plans.items():
        ex, p = t._exec, t.params
        S, A, Y, Z = p.num_sticks, ex.num_x_active, p.dim_y, p.dim_z
        sticks = [torch.randn((S, Z), generator=gen, device="cuda") for _ in range(2)]
        planes = [torch.randn((Y * A, Z), generator=gen, device="cuda") for _ in range(2)]
        row, key = run_k2(f"{kind}/expand", sticks, ex._yx_map)
        rows.append((row, kind, "row_gather", key))
        row, key = run_k2(f"{kind}/pack", planes, ex._stick_keys)
        rows.append((row, kind, "row_gather", key))

    # K1 in float64, small: every form, against the plain version
    g64 = torch.Generator(device="cuda").manual_seed(SEED + 2)
    r = lambda *s: torch.randn(s, generator=g64, device="cuda", dtype=torch.float64)
    f64_err = 0.0
    w_r, w_i = r(24, 40), r(24, 40)
    shared = lambda w: w.mT.expand(3, -1, -1)
    for ops, want in (
        ((r(1, 300, 64), r(1, 300, 64), r(1, 64, 64), r(1, 64, 64)), True),
        ((shared(w_r), shared(w_i), r(3, 24, 70), r(3, 24, 70)), True),
        ((shared(w_r), shared(w_i), r(3, 24, 70), None), True),
        ((shared(w_r), shared(w_i), r(3, 24, 70), r(3, 24, 70)), False),
    ):
        cr, ci = k1.complex_matmul(*ops, want)
        pr, pi = k1.complex_matmul_plain(*ops, want)
        err = (cr - pr).abs().max().item() / pr.abs().max().item()
        if want:
            err = max(err, (ci - pi).abs().max().item() / pi.abs().max().item())
        f64_err = max(f64_err, err)
    emit({"phase": "kernel_f64", "name": "complex_matmul", "rel_err": f64_err})
    check(f64_err <= K1_F64_RTOL, f"complex_matmul float64 rel err {f64_err}")

    # ---- the main path, each transform type with the counts set to 0 before it ----
    counts = {}
    for kind, t in plans.items():
        counts[kind] = main_path(sp, kind, t, triplets[kind], triplets["c2c"])

    kernels = []
    for row, kind, kernel, key in rows:
        launches = counts[kind][kernel].get(key, 0)
        check(launches > 0, f"{row['name']} was not launched by the main path")
        kernels.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")} | {"launches": launches})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
