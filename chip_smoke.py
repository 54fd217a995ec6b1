#!/usr/bin/env python3
"""Drives spfft_tpu_torch on one CUDA card and holds every kernel to its plain version.

Run from the root of a checkout, on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit), the kernel build, and
   what ptxas reports for each kernel (registers, spills) and how many
   tensor-core instructions (``HGMMA``, ``HMMA``) ``cuobjdump -sass`` finds;
2. each kernel (K1 ``complex_matmul``, K2 ``row_gather``) at the shapes the
   main path gives it, against its plain PyTorch version on the same inputs,
   with its device time (``ms``: one call captured in a CUDA graph, replayed
   ``REPLAYS`` times between two events), the plain version's and one
   PyTorch library call's device time, the single-call time with the host's
   share in it (``call_ms``), and the least time the card could take
   (``bound_ms``; K1's on the TF32 tensor cores, ``fp32_bound_ms`` without
   them); K1 at odd shapes and strides in f32, and once more in f64;
3. the main path at full width: ``Transform(ProcessingUnit.GPU, ...)`` at
   256^3 with the spherical cutoff 0.659, C2C and R2C in float32, backward then
   forward(FULL), against a complex128 dense oracle on the host, with the
   kernels' launch counts from that run and the median ms per pair;
4. one pair of each kind under ``torch.profiler``: the device's busy share
   and the kernels that take its time;
5. the ``kernels`` line; last, the ``{"ok": true, "device": ...}`` line.

Exits non-zero, with no result line, when there is no CUDA device or any
check fails.
"""
from __future__ import annotations

import json
import re
import shutil
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
REPLAYS = 20
# H100 SXM published peaks (NVIDIA data sheet, 700 W): FP32 and FP64 outside
# the tensor cores, dense TF32 on them, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_TF32 = 495e12
TF32_PASSES = 3  # 3xTF32: three tensor-core products per real product
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def call_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after ``warmup`` calls:
    the card's time plus whatever the host keeps it waiting."""
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


def device_ms(fn, replays: int = REPLAYS) -> float:
    """Device time of one call: warmed up (build, argtypes, allocator), then
    captured in a CUDA graph and replayed ``replays`` times between two events."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / replays


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def build_report(names) -> dict:
    """ptxas's registers and spills per kernel, from the build logs, and the
    tensor-core instructions in each library's SASS."""
    from spfft_tpu_torch import _build

    demangle = shutil.which("c++filt")
    report = {}
    for name in names:
        log = _build.build_log(name)
        kernels = []
        for entry, body in re.findall(
            r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S
        ):
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            kernels.append({"kernel": entry, "registers": int(regs.group(1)) if regs else None,
                            "spill_store_bytes": int(spill.group(1)) if spill else None})
        if demangle and kernels:
            out = subprocess.run([demangle], input="\n".join(k["kernel"] for k in kernels),
                                 capture_output=True, text=True).stdout.splitlines()
            for k, d in zip(kernels, out):
                k["kernel"] = d
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([cuobjdump, "-sass", str(_build._target(name))],
                              capture_output=True, text=True).stdout
        report[name] = {
            "kernels": kernels,
            "warnings": [ln.strip() for ln in log.splitlines()
                         if "warning" in ln.lower() or "Performance Loss" in ln],
            "sass_hgmma": len(re.findall(r"\bHGMMA\b", sass)),
            "sass_hmma": len(re.findall(r"\bHMMA\b", sass)),
        }
    return report


def k1_forms(plans):
    """Every K1 form the main path launches: (name, plan kind, spec, x, constant, want_imag)."""
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


def k1_bounds_ms(ops, want_imag) -> tuple[float, str, float]:
    """(TF32 bound, what bounds it, FP32 bound): max(operations over the peak,
    bytes over the memory rate), the operations 3xTF32's three tensor-core
    products per real product on the TF32 peak, or one on the FP32 peak."""
    ar, ai, br, bi = ops
    batch, m, k = ar.shape
    n = br.shape[2]
    products = 4 if (ai is not None and bi is not None and want_imag) else 2
    flops = 2 * products * batch * m * n * k
    item = ar.element_size()
    a_mats = batch if ar.stride(0) else 1
    b_mats = batch if br.stride(0) else 1
    nbytes = item * (
        (1 + (ai is not None)) * a_mats * m * k
        + (1 + (bi is not None)) * b_mats * k * n
        + (1 + want_imag) * batch * m * n
    )
    t_bytes = nbytes / PEAK_BYTES
    t_tf32 = TF32_PASSES * flops / PEAK_TF32
    t_fp32 = flops / PEAK_FLOPS[str(ar.dtype).split(".")[1]]
    bound_by = "operations" if t_tf32 >= t_bytes else "bytes"
    return 1e3 * max(t_tf32, t_bytes), bound_by, 1e3 * max(t_fp32, t_bytes)


def k1_err(ops, want_imag, constant=None):
    """K1 against its plain version: (max abs diff, max |plain|), each per
    part of the result (real, then imaginary when it is kept)."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1

    got = k1.complex_matmul(*ops, want_imag, constant=constant)
    want = k1.complex_matmul_plain(*ops, want_imag)
    torch.cuda.synchronize()
    parts = [(g, w) for g, w in zip(got, want) if w is not None]
    return ([(g - w).abs().max().item() for g, w in parts],
            [w.abs().max().item() for _, w in parts])


def k1_feed_bytes(ops, w) -> int:
    """Bytes the float32 kernel copies into shared memory for this call: per
    output tile (128 rows of D by a Q tile of V) and K tile of 32, the D
    tile's parts and the V tile's TF32 planes (csrc/complex_matmul.cu, tc::)."""
    from spfft_tpu_torch.ops import complex_matmul as k1

    ar, ai, br, bi = ops
    batch, m, k = ar.shape
    n = br.shape[2]
    transposed = not k1._views(br, w.re)
    p, q = (n, m) if transposed else (m, n)
    d_parts = 1 + ((bi if transposed else ai) is not None)
    planes = 2 * (1 + (w.im is not None))
    bn, ceil = k1.tile_q(q), lambda a, b: -(-a // b)
    tiles = batch * ceil(p, 128) * ceil(q, bn)
    return 4 * tiles * ceil(k, k1.TILE_K) * k1.TILE_K * (128 * d_parts + bn * planes)


def run_k1(name, spec, x, w, want_imag):
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import fft as offt

    ops, _ = offt.operands(spec, x[0], x[1], w.re, w.im)
    errs, scales = k1_err(ops, want_imag, w)
    err, scale = max(errs), max(scales)
    ar, ai, br, bi = ops
    a_c = torch.complex(ar[:1] if ar.stride(0) == 0 else ar, ai[:1] if ai.stride(0) == 0 else ai)
    b_c = torch.complex(br, bi if bi is not None else torch.zeros_like(br))
    lib = (lambda: torch.matmul(a_c, b_c)) if want_imag else (lambda: torch.matmul(a_c, b_c).real)
    kernel = lambda: k1.complex_matmul(*ops, want_imag, constant=w)
    bound, bound_by, fp32_bound = k1_bounds_ms(ops, want_imag)
    row = {
        "name": f"complex_matmul:{name}", "route": "cuda",
        "source": "spfft_tpu_torch/csrc/complex_matmul.cu",
        "replaces": "spfft_tpu/ops/pallas_fft.py:95",
        "shape": {"batch": ar.shape[0], "M": ar.shape[1], "K": ar.shape[2], "N": br.shape[2]},
        "max_abs_err": err, "rel_err": err / scale,
        "ms": device_ms(kernel),
        "plain_ms": device_ms(lambda: k1.complex_matmul_plain(*ops, want_imag)),
        "library_ms": device_ms(lib),
        "call_ms": call_ms(kernel),
        "bound_ms": bound, "bound_by": bound_by, "fp32_bound_ms": fp32_bound,
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    # what the tiles draw from L2 into shared memory, and at what rate
    row["feed_bytes"] = k1_feed_bytes(ops, w)
    row["feed_tb_s"] = row["feed_bytes"] / row["ms"] / 1e9
    emit({"phase": "kernel", **row})
    check(err <= K1_RTOL * scale, f"{row['name']} differs from its plain version: {err} vs {scale}")
    return row, k1_key(ops, want_imag)


def run_k1_odd(phase, dtype, rtol):
    """K1 at shapes that are not multiples of its tiles, with strides and
    pointers that are not 16-byte aligned, against its plain version."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    r = lambda *s: torch.randn(s, generator=g, device="cuda", dtype=dtype)
    w_r, w_i = r(24, 40), r(24, 40)
    shared = lambda w: w.mT.expand(3, -1, -1)
    odd = lambda *s: r(*s[:-1], s[-1] + 1)[..., 1:]  # last axis contiguous, pointer off by one
    cases = {
        "300x64@64x64": ((r(1, 300, 64), r(1, 300, 64), r(1, 64, 64), r(1, 64, 64)), True),
        "shared 40x24 @ 3x24x70": ((shared(w_r), shared(w_i), r(3, 24, 70), r(3, 24, 70)), True),
        "shared @ real": ((shared(w_r), shared(w_i), r(3, 24, 70), None), True),
        "shared, real part only": ((shared(w_r), shared(w_i), r(3, 24, 70), r(3, 24, 70)), False),
        "unaligned 301x70@70x90": ((odd(1, 301, 70), odd(1, 301, 70), r(1, 70, 90), r(1, 70, 90)),
                                   True),
        "shared @ unaligned 3x24x177": ((shared(w_r), shared(w_i), odd(3, 24, 177), odd(3, 24, 177)),
                                        True),
        "batched 3x30x9 @ 3x9x50": ((r(3, 30, 9), r(3, 30, 9), r(3, 9, 50), r(3, 9, 50)), True),
        "real @ transposed": ((r(2, 33, 45), None, r(2, 120, 45).mT, r(2, 120, 45).mT), True),
    }
    errs = {}
    for name, (ops, want) in cases.items():
        err, scale = k1_err(ops, want)
        errs[name] = max(e / s for e, s in zip(err, scale))
    worst = max(errs.values())
    emit({"phase": phase, "name": "complex_matmul", "rel_err": errs})
    check(worst <= rtol, f"complex_matmul {dtype} at odd shapes: rel err {worst}")


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
    kernel = lambda: k2.row_gather(src[0], src[1], idx)
    row = {
        "name": f"row_gather:{name}", "route": "cuda",
        "source": "spfft_tpu_torch/csrc/row_gather.cu",
        "replaces": "programs/microbench_pallas_dma.py:140",
        "shape": {"rows": idx.numel(), "n_src": n_src, "width": width, "planes": 2},
        "max_abs_err": err, "bitwise_equal": exact,
        "ms": device_ms(kernel),
        "plain_ms": device_ms(lambda: (k2.row_gather_plain(src[0], idx),
                                       k2.row_gather_plain(src[1], idx))),
        "library_ms": device_ms(lambda: torch.index_select(both, 1, il)),
        "call_ms": call_ms(kernel),
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit({"phase": "kernel", **row})
    check(exact, f"{row['name']} is not bitwise equal to its plain version")
    return row, (idx.numel(), n_src, width, 2)


def storage(idx, dim):
    return np.where(idx < 0, idx + dim, idx)


def main_path(sp, kind, t, triplets, full_triplets):
    """One backward + forward(FULL) through the entry points, checked against a
    dense complex128 oracle; returns the launch counts of that run and the
    device values it ran on."""
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
    return counts, values_dev


def profile_pair(sp, kind, t, values_dev) -> None:
    """One backward+forward(FULL) pair under torch.profiler: the share of the
    window the device is busy, and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.backward(values_dev)
        t.forward(scaling=sp.ScalingType.FULL)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, reach = 0.0, None
    for start, end in spans:  # union of the kernels' intervals
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    by_name = {}
    for e in kernels:
        name = e.name if len(e.name) <= 90 else e.name[:87] + "..."
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({
        "phase": "profile", "transform": kind, "window_ms": window_ms,
        "device_busy_ms": busy_us / 1e3 if spans else None,
        "device_busy_share": busy_us / 1e3 / window_ms if spans else None,
        "kernels": len(kernels),
        "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top],
    })


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0)})
    names = ["complex_matmul", "row_gather"]
    t0 = time.perf_counter()
    _build.build_all(names)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, **build_report(names)})

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
    run_k1_odd("kernel_f32_odd", torch.float32, K1_RTOL)
    run_k1_odd("kernel_f64", torch.float64, K1_F64_RTOL)

    # ---- the main path, each transform type with the counts set to 0 before it ----
    counts, values = {}, {}
    for kind, t in plans.items():
        counts[kind], values[kind] = main_path(sp, kind, t, triplets[kind], triplets["c2c"])
    for kind, t in plans.items():
        profile_pair(sp, kind, t, values[kind])

    kernels = []
    for row, kind, kernel, key in rows:
        launches = counts[kind][kernel].get(key, 0)
        check(launches > 0, f"{row['name']} was not launched by the main path")
        kernels.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "call_ms", "bound_share")}
            | {"launches": launches}
            | ({"fp32_bound_ms": row["fp32_bound_ms"]} if "fp32_bound_ms" in row else {}))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
