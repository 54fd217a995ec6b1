#!/usr/bin/env python3
"""Drives spfft_tpu_torch on one CUDA card and holds every kernel to its plain version.

Run from the root of a checkout, on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit), the kernel build (K1 at
   its three float32 precisions and in float64, and K2, one ``nvcc`` each, in
   parallel), and what ptxas reports for each kernel (registers, spills) and
   how many tensor-core instructions (``HGMMA``, ``HMMA``, the float64
   library's ``DMMA``) ``cuobjdump -sass`` finds;
2. the plans, all at 256^3 (``PLANS``): in float32, C2C and R2C at the
   spherical cutoff 0.659 with the dense y stage (``SPFFT_TPU_SPARSE_Y_BLOCKS=0``)
   and with the JAX package's choice (blocked sparse-y) at ``precision``
   "highest", "high" and "default", and C2C at 0.5 (per-slot sparse-y, and
   dense beside it); in float64, C2C and R2C at 0.659, blocked; each plan's
   y variant, bucket shapes and Sy are asserted (``EXPECT``);
3. each kernel (K1 ``complex_matmul``, K2 ``row_gather``) at the shapes the
   main path gives it, against its plain PyTorch version on the same inputs
   (K1 "highest": the exact float32 products; "high"/"default": the bf16x3 /
   bf16x1 arithmetic), with its device time (``ms``: one call captured in a
   CUDA graph, replayed ``REPLAYS`` times between two events), the plain
   version's and one PyTorch library call's device time (K1: cuBLAS
   complex64 in FP32; for the bf16 rows also with TF32 allowed), for K1
   "highest"/"high" how far the other precision's arithmetic lies from the
   plain version (it must fail the bar that the kernel passes), the
   single-call time with the host's share in it (``call_ms``), and the least
   time the card could take (``bound_ms``: K1's on the TF32 tensor cores, or
   the BF16 ones for "high"/"default", or the FP64 ones for float64, where
   the full complex forms take Gauss's three products; ``fp32_bound_ms``
   without tensor cores, four products); K1 at odd shapes and strides at
   each float32 precision, and once more in float64 (there also K = 0 and a
   real constant);
4. the main path at full width: ``Transform(ProcessingUnit.GPU, ...)`` for
   every plan, backward then forward(FULL), against a complex128 dense oracle
   on the host (one per transform and radius), at the bar of the plan's
   precision (float64: 1e-12). Each plan runs fused (its
   default: one CUDA graph per direction, captured at the first call) and
   has a ``fuse=False`` twin that runs node by node. The kernels' launch
   counts come from the twin's pair, where each launch counts once; the
   fused plan's first pair (warm-up and capture) must count exactly twice
   as many, its second pair (replays) none, and both must be bitwise equal
   to the twin's results. Two more plans, ``c2c-xla`` and ``r2c-xla``, run
   the ``torch.fft`` engine (cuFFT; no K1 or K2 launch);
5. a result handed out stays put across a later call (fused C2C and R2C);
   ``backward_batch``/``forward_batch`` with B = 4 against the per-request
   calls (one batched dispatch per direction, ms per transform against the
   loop); ``multi_transform_backward``/``_forward`` of the C2C and R2C
   headline plans against their single calls;
6. the distributed phase (``DIST_PLANS``): ``DistributedTransform`` over
   ``make_fft_mesh(4)``, four shards stacked on the card, at 256^3: C2C and
   R2C with ``engine="auto"`` (which must be ``mxu``) and the DEFAULT
   exchange, a skewed C2C plan (weights 2:1:1:1, z-slabs 70/62/62/62,
   UNBUFFERED), C2C in float64 over a float32 wire (BUFFERED_FLOAT), C2C on
   the ``torch.fft`` engine, and C2C over a one-rank NCCL process group (the
   collective route, staged). Each is held against the dense oracle, the
   local blocked plan of the same triplets, its round trip, its staged twin
   (bitwise), and the NCCL plan against the one without a group (bitwise);
   its K1 and K2 forms against their plain versions, as in phase 3;
7. one pair of every plan and twin under ``torch.profiler``: the device's
   busy share and the kernels that take its time; then the pair times, all
   plans taking turns, for comparisons within the run;
8. the ``kernels`` line; last, the ``{"ok": true, "device": ...}`` line.

Exits non-zero, with no result line, when there is no CUDA device or any
check fails.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

DIMS = (256, 256, 256)
SEED = 1234
# kernel vs its plain version, max abs diff over max |plain|, float32: below
# the gap between the "highest" and "high" arithmetics (2.2e-6 to 4.7e-6 at
# the main path's forms on an H100), so that a body of the wrong precision
# fails it; the kernels' own differences reach about 1e-6
K1_RTOL = 1.5e-6
K1_F64_RTOL = 1e-12
# backward against the dense oracle, and the round trip, per precision
ORACLE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 2e-2}
# the same in float64: a sound float64 plan reads about 1e-13 at 256^3 on an
# H100, the float64 mesh plan over a float32 wire 2.6e-8, so any float32
# step fails it
ORACLE_F64_RTOL = 1e-12
REPLAYS = 20
# H100 SXM published peaks (NVIDIA data sheet, 700 W): FP32 and FP64 outside
# the tensor cores, dense TF32, BF16 and FP64 on them, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_F64_TC = 67e12  # FP64 on the tensor cores (the data sheet's FP64 Tensor Core rate)
PEAK_TC = {"highest": 495e12, "high": 989e12, "default": 989e12}  # TF32, BF16, BF16
TC_PASSES = {"highest": 3, "high": 3, "default": 1}  # tensor-core products per real product
OTHER = {"highest": "high", "high": "highest"}  # the precision a K1 row must not pass as
PEAK_BYTES = 3.35e12
LIBRARIES = ["complex_matmul", "complex_matmul_bf16x3", "complex_matmul_bf16x1",
             "complex_matmul_f64", "row_gather"]
BLOCKS_OFF = {"SPFFT_TPU_SPARSE_Y_BLOCKS": "0"}
F32, F64 = np.float32, np.float64
# (name, transform, radius, precision, knobs while the plan is made, y plan, dtype)
PLANS = [
    ("c2c", "c2c", 0.659, "highest", BLOCKS_OFF, "dense", F32),
    ("r2c", "r2c", 0.659, "highest", BLOCKS_OFF, "dense", F32),
    ("c2c-blocked", "c2c", 0.659, "highest", {}, "blocked", F32),
    ("r2c-blocked", "r2c", 0.659, "highest", {}, "blocked", F32),
    ("c2c-r0.5", "c2c", 0.5, "highest", {}, "per-slot", F32),
    ("c2c-r0.5-dense", "c2c", 0.5, "highest", {"SPFFT_TPU_SPARSE_Y": "0", **BLOCKS_OFF}, "dense",
     F32),
    ("c2c-blocked-high", "c2c", 0.659, "high", {}, "blocked", F32),
    ("r2c-blocked-high", "r2c", 0.659, "high", {}, "blocked", F32),
    ("c2c-blocked-default", "c2c", 0.659, "default", {}, "blocked", F32),
    ("r2c-blocked-default", "r2c", 0.659, "default", {}, "blocked", F32),
    ("c2c-blocked-f64", "c2c", 0.659, "highest", {}, "blocked", F64),
    ("r2c-blocked-f64", "r2c", 0.659, "highest", {}, "blocked", F64),
]
# The torch.fft engine's plans: (name, transform, radius)
XLA_PLANS = [("c2c-xla", "c2c", 0.659), ("r2c-xla", "r2c", 0.659)]
STAGED = "~staged"  # the name suffix of a plan's fuse=False twin
BATCH = 4
# What the JAX package's planner chooses at 256^3 (its buckets (Ag, Syg), or Sy)
EXPECT = {
    ("c2c", 0.659): [(42, 176), (42, 168), (42, 152), (43, 120)],
    ("r2c", 0.659): [(21, 176), (21, 168), (21, 152), (21, 112), (1, 256)],
    ("c2c", 0.5): 136,
}
SLOTS_OUT, SLOTS_IN = "ajz,ajk->kaz", "yaz,ajy->ajz"
# The distributed phase, 4 shards, radius 0.659: (name, transform, engine,
# exchange, dtype, shard weights, local_z_lengths, over a process group, the
# local plan it is held against)
DIST_PLANS = [
    ("dist4-c2c", "c2c", "auto", "DEFAULT", np.float32, None, None, False, "c2c-blocked"),
    ("dist4-r2c", "r2c", "auto", "DEFAULT", np.float32, None, None, False, "r2c-blocked"),
    ("dist4-c2c-skewed", "c2c", "mxu", "UNBUFFERED", np.float32, (2, 1, 1, 1),
     (70, 62, 62, 62), False, "c2c-blocked"),
    ("dist4-c2c-f64-float", "c2c", "mxu", "BUFFERED_FLOAT", np.float64, None, None, False,
     "c2c-blocked"),
    ("dist4-c2c-xla", "c2c", "xla", "DEFAULT", np.float32, None, None, False, "c2c-blocked"),
    ("dist4-c2c-nccl1", "c2c", "auto", "DEFAULT", np.float32, None, None, True, "c2c-blocked"),
]
# float64 over a float32 wire, the oracle and the round trip: between what a
# sound plan reads (about 3e-8) and what the same plan computed in float32
# would (about 1.2e-6, the float32 distributed plans' reading), with room both ways
DIST_F64_RTOL = 2e-7


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


@contextlib.contextmanager
def knobs(env):
    """The process environment with ``env`` set, restored afterwards."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
            "sass_hgmma_bf16": len(re.findall(r"\bHGMMA\.\S*BF16", sass)),
            "sass_hgmma_first": next((ln.strip() for ln in sass.splitlines() if "HGMMA" in ln), None),
            "sass_hmma": len(re.findall(r"\bHMMA\b", sass)),
            "sass_dmma": len(re.findall(r"\bDMMA\b", sass)),
            "sass_dmma_first": next((ln.strip() for ln in sass.splitlines() if "DMMA" in ln), None),
        }
    return report


def k1_forms(name, t):
    """Every K1 form plan ``name`` launches that gets a row: (row name, spec,
    data pair, constant, want_imag, out pair or None). Dense plans: all four
    of their forms; the blocked and per-slot plans at float32 "highest": their
    y forms; at "high"/"default" and in float64: all (the non-y three and the
    y forms)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ex, p = t._exec, t.params
    S, A, Y, X, Z = p.num_sticks, ex.num_x_active, p.dim_y, p.dim_x, p.dim_z
    f64 = ex.torch_dtype == torch.float64
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=ex.torch_dtype)
    pair = lambda *shape: (rnd(*shape), rnd(*shape))
    r2c = ex.is_r2c
    forms = []
    if ex.y_plan == "dense" or ex.precision != "highest" or f64:
        forms.append((f"{name}/z", "sz,zk->sk", pair(S, Z), ex._wz_b, True, None))
        if ex.y_plan == "dense":
            forms.append((f"{name}/y", "yxz,yk->kxz", pair(Y, A, Z), ex._wy_b, True, None))
        if r2c:
            forms.append((f"{name}/x_backward_real_out", "kxz,xl->klz", pair(Y, A, Z), ex._wx_b,
                          False, None))
            forms.append((f"{name}/x_forward_real_in", "yxz,xk->ykz", (rnd(Y, X, Z), None),
                          ex._wx_f, True, None))
        else:
            forms.append((f"{name}/x_backward", "kxz,xl->klz", pair(Y, A, Z), ex._wx_b, True, None))
            forms.append((f"{name}/x_forward", "yxz,xk->ykz", pair(Y, X, Z), ex._wx_f, True, None))
    if ex.y_plan == "per-slot":
        forms.append((f"{name}/slot_backward", SLOTS_OUT, pair(A, ex.sy, Z), ex._wy_b, True, None))
        forms.append((f"{name}/slot_forward", SLOTS_IN, pair(Y, A, Z), ex._wy_f, True, None))
    elif ex.y_plan == "blocked":
        grid, col = pair(Y, A, Z), 0
        for b, (ag, syg, wb, wf) in enumerate(ex.buckets):
            cols = tuple(g[:, col:col + ag] for g in grid)  # the grid columns it writes or reads
            forms.append((f"{name}/bucket{b}_backward", SLOTS_OUT, pair(ag, syg, Z), wb, True, cols))
            forms.append((f"{name}/bucket{b}_forward", SLOTS_IN, cols, wf, True, None))
            col += ag
    return forms


def k1_operands(spec, x, w):
    """K1's operands of stage ``spec`` on data ``x`` with plan constant ``w``."""
    from spfft_tpu_torch.ops import fft as offt

    return offt.operands(spec, x[0], x[1], *offt.constant_operands(spec, w))[0]


def k1_key(ops, want_imag, precision):
    ar, ai, br, bi = ops
    return (ar.shape[0], ar.shape[1], ar.shape[2], br.shape[2], ai is not None,
            bi is not None, want_imag, precision)


def k1_bounds_ms(ops, want_imag, precision, w) -> tuple[float, str, float]:
    """(tensor-core bound, what bounds it, FP32 or FP64 bound without tensor
    cores): max(operations over the peak, bytes over the memory rate); the
    operations are the precision's tensor-core products per real product on
    the TF32 ("highest") or BF16 peak, the real products the float64 kernel
    issues on the FP64 tensor-core peak (three per complex product where all
    four parts exist: Gauss's form), or the four-product form's on the FP32
    or FP64 peak. The bytes count the data and the result in their dtype and
    the plan constant ``w`` as the precision needs it: one bf16 plane per
    part at "default" (its tiles are made once per plan), the dtype's size
    else."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1

    ar, ai, br, bi = ops
    batch, m, k = ar.shape
    n = br.shape[2]
    full = ai is not None and bi is not None and want_imag
    products = 4 if full else 2
    flops = 2 * products * batch * m * n * k
    item = ar.element_size()
    v_item = 2 if precision == "default" else item
    a_item, b_item = (item, v_item) if k1._views(br, w.re) else (v_item, item)
    a_mats = batch if ar.stride(0) else 1
    b_mats = batch if br.stride(0) else 1
    nbytes = (
        a_item * (1 + (ai is not None)) * a_mats * m * k
        + b_item * (1 + (bi is not None)) * b_mats * k * n
        + item * (1 + want_imag) * batch * m * n
    )
    t_bytes = nbytes / PEAK_BYTES
    t_fp32 = flops / PEAK_FLOPS[str(ar.dtype).split(".")[1]]
    # float64: the card's FP64 peak on its tensor cores, where K1's float64
    # body runs, at the products it issues
    t_tc = ((3 if full else products) * flops / products / PEAK_F64_TC
            if ar.dtype == torch.float64 else TC_PASSES[precision] * flops / PEAK_TC[precision])
    bound_by = "operations" if t_tc >= t_bytes else "bytes"
    return 1e3 * max(t_tc, t_bytes), bound_by, 1e3 * max(t_fp32, t_bytes)


def k1_plain(precision):
    """K1's plain version at ``precision``: the exact float32 products for
    "highest" (FP32 accuracy is its contract), the bf16 arithmetic else."""
    from spfft_tpu_torch.ops import complex_matmul as k1

    return k1.complex_matmul_plain if precision == "highest" else k1.ARITHMETIC[precision]


def k1_err(ops, want_imag, constant=None, precision="highest", out=None):
    """K1 against its plain version: (max abs diff, max |plain|), each per
    part of the result (real, then imaginary when it is kept)."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1

    got = k1.complex_matmul(*ops, want_imag, constant=constant, precision=precision, out=out)
    want = k1_plain(precision)(*ops, want_imag)
    torch.cuda.synchronize()
    parts = [(g, w) for g, w in zip(got, want) if w is not None]
    return ([(g - w).abs().max().item() for g, w in parts],
            [w.abs().max().item() for _, w in parts])


def k1_feed_bytes(ops, w) -> int:
    """Bytes the tensor-core kernel copies into shared memory for this call:
    per output tile (128 rows of D by a Q tile of V) and K tile, the D tile's
    float32 parts and the V tile's planes (csrc/k1_tc.cuh)."""
    from spfft_tpu_torch.ops import complex_matmul as k1

    ar, ai, br, bi = ops
    batch, m, k = ar.shape
    n = br.shape[2]
    transposed = not k1._views(br, w.re)
    p, q = (n, m) if transposed else (m, n)
    d_parts = 1 + ((bi if transposed else ai) is not None)
    tk = w.tiles.shape[-1]
    v_row = tk * w.tiles.element_size()  # bytes of one V tile row: 128
    v_rows = w.tiles.shape[3]  # planes
    bn, ceil = k1.tile_q(q), lambda a, b: -(-a // b)
    tiles = batch * ceil(p, 128) * ceil(q, bn)
    return tiles * ceil(k, tk) * (128 * tk * 4 * d_parts + bn * v_rows * v_row)


def run_k1(name, spec, x, w, want_imag, precision, out=None):
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import fft as offt

    ops = k1_operands(spec, x, w)
    outv = None if out is None else tuple(offt.result_view(spec, o) for o in out)
    errs, scales = k1_err(ops, want_imag, w, precision, outv)
    err, scale = max(errs), max(scales)
    f64 = ops[0].dtype == torch.float64
    rtol = K1_F64_RTOL if f64 else K1_RTOL
    ar, ai, br, bi = ops
    whole = lambda t: t[:1] if t.stride(0) == 0 else t
    a_c = torch.complex(whole(ar), whole(ai) if ai is not None else torch.zeros_like(whole(ar)))
    b_c = torch.complex(br, bi if bi is not None else torch.zeros_like(br))
    lib = (lambda: torch.matmul(a_c, b_c)) if want_imag else (lambda: torch.matmul(a_c, b_c).real)
    kernel = lambda: k1.complex_matmul(*ops, want_imag, constant=w, precision=precision, out=outv)
    plain = k1_plain(precision)
    bound, bound_by, fp32_bound = k1_bounds_ms(ops, want_imag, precision, w)
    library = k1.LIBRARY_F64[0] if f64 else k1.LIBRARIES[precision][0]
    row = {
        "name": f"{library}:{name}", "route": "cuda",
        "source": f"spfft_tpu_torch/csrc/{library}.cu",
        "replaces": "spfft_tpu/ops/pallas_fft.py:95",
        "precision": "float64" if f64 else precision,
        "shape": {"batch": ar.shape[0], "M": ar.shape[1], "K": ar.shape[2], "N": br.shape[2]},
        "max_abs_err": err, "rel_err": err / scale,
        "ms": device_ms(kernel),
        "plain_ms": device_ms(lambda: plain(*ops, want_imag)),
        "library_ms": device_ms(lib),
        "library_math": "cuBLAS complex128" if f64 else "cuBLAS complex64, allow_tf32=False",
        "call_ms": call_ms(kernel),
        "bound_ms": bound, "bound_by": bound_by, "fp32_bound_ms": fp32_bound,
    }
    if precision != "highest" and not f64:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            row["library_tf32_ms"] = device_ms(lib)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    row["bound_share"] = row["bound_ms"] / row["ms"]
    if not f64:
        # what the tiles draw from L2 into shared memory, and at what rate
        row["feed_bytes"] = k1_feed_bytes(ops, w)
        row["feed_tb_s"] = row["feed_bytes"] / row["ms"] / 1e9
    if precision in OTHER and not f64:
        # the other float32-accurate arithmetic on the same inputs: the bar
        # must tell it from this precision's
        want, alt = plain(*ops, want_imag), k1_plain(OTHER[precision])(*ops, want_imag)
        row["other_arithmetic_rel_err"] = max(
            (a - b).abs().max().item() for a, b in zip(alt, want) if b is not None) / scale
    emit({"phase": "kernel", **row})
    check(err <= rtol * scale, f"{row['name']} differs from its plain version: {err} vs {scale}")
    if precision in OTHER and not f64:
        check(row["other_arithmetic_rel_err"] > K1_RTOL,
              f"{row['name']}: the {OTHER[precision]} arithmetic passes the {precision} bar")
    return row, k1_key(ops, want_imag, precision)


def run_k1_odd(phase, dtype, rtol, precision="highest"):
    """K1 at shapes that are not multiples of its tiles, with strides and
    pointers that are not 16-byte aligned, with a constant per batch entry and
    with strided outputs, against its plain version."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1

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
        "per-batch 5x(130,70)^T @ 5x130x90": ((r(5, 130, 70).mT, r(5, 130, 70).mT, r(5, 130, 90),
                                              r(5, 130, 90)), True),
    }
    if dtype == torch.float64:
        cases.update({
            "K = 0, 3x30x0 @ 3x0x50": ((r(3, 30, 0), r(3, 30, 0), r(3, 0, 50), r(3, 0, 50)), True),
            "real shared constant @ 3x24x70": ((shared(w_r), None, r(3, 24, 70), r(3, 24, 70)),
                                               True),
        })
    errs = {}
    for name, (ops, want) in cases.items():
        err, scale = k1_err(ops, want, precision=precision)
        # relative to the largest output, absolute where every output is 0 (K = 0)
        errs[name] = max(e / s if s else e for e, s in zip(err, scale))
    # a strided output: columns of a wider grid, as the sparse-y stages write
    ops = (r(4, 60, 36).mT, r(4, 60, 36).mT, r(4, 60, 50), r(4, 60, 50))
    grid = [r(36, 7, 50) for _ in range(2)]
    before = [gr.clone() for gr in grid]
    out = tuple(gr[:, 2:6].permute(1, 0, 2) for gr in grid)
    err, scale = k1_err(ops, True, precision=precision, out=out)
    errs["strided out 4x36x50 in a 36x7x50 grid"] = max(e / s for e, s in zip(err, scale))
    untouched = all(torch.equal(gr[:, c], b[:, c]) for gr, b in zip(grid, before) for c in (0, 1, 6))
    worst = max(errs.values())
    emit({"phase": phase, "name": "complex_matmul", "precision": precision, "rel_err": errs,
          "strided_out_left_other_columns": untouched})
    check(worst <= rtol, f"complex_matmul {dtype} {precision} at odd shapes: rel err {worst}")
    check(untouched, f"complex_matmul {dtype} {precision} wrote outside its strided output")


def run_k2(name, src, idx, packed=False):
    """K2 at one form against its plain version. ``packed``: the planes'
    rows go side by side into one ``(rows, planes * W)`` buffer, as the
    exchange's pack writes them (its unpack reads such a buffer's column
    blocks, which ``src`` then is)."""
    import torch
    from spfft_tpu_torch.ops import row_gather as k2

    src = [t for t in src if t is not None]
    n_src, width = src[0].shape
    second = src[1] if len(src) > 1 else None

    def kernel():
        if not packed:
            return k2.row_gather(src[0], second, idx)
        buf = src[0].new_empty((idx.numel(), len(src) * width))
        cols = [buf[:, q * width:(q + 1) * width] for q in range(len(src))]
        return k2.row_gather(src[0], second, idx, out=(cols[0], cols[1] if second is not None
                                                        else None))

    got = [o for o in kernel() if o is not None]
    want = [k2.row_gather_plain(t, idx) for t in src]
    torch.cuda.synchronize()
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    il = idx.long()
    valid = (il >= 0) & (il < n_src)
    both = torch.stack([torch.cat([s, s.new_zeros((1, width))]) for s in src])
    il = torch.where(valid, il, torch.full_like(il, n_src))
    item = src[0].element_size()
    rows_read = torch.unique(il[valid]).numel()
    nbytes = len(src) * item * width * (rows_read + idx.numel()) + idx.element_size() * idx.numel()
    row = {
        "name": f"row_gather:{name}", "route": "cuda",
        "source": "spfft_tpu_torch/csrc/row_gather.cu",
        "replaces": "programs/microbench_pallas_dma.py:140",
        "shape": {"rows": idx.numel(), "n_src": n_src, "width": width, "planes": len(src),
                  "dtype": str(src[0].dtype).split(".")[1], "ld_src": src[0].stride(0),
                  "packed_out": packed},
        "max_abs_err": err, "bitwise_equal": exact,
        "ms": device_ms(kernel),
        "plain_ms": device_ms(lambda: [k2.row_gather_plain(t, idx) for t in src]),
        "library_ms": device_ms(lambda: torch.index_select(both, 1, il)),
        "call_ms": call_ms(kernel),
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit({"phase": "kernel", **row})
    check(exact, f"{row['name']} is not bitwise equal to its plain version")
    return row, (idx.numel(), n_src, width, len(src))


def k2_forms(name, t, gen):
    """Every K2 form plan ``name`` launches: (row name, source pair, index)."""
    import torch

    ex, p = t._exec, t.params
    S, A, Y, Z = p.num_sticks, ex.num_x_active, p.dim_y, p.dim_z
    rnd = lambda rows: [torch.randn((rows, Z), generator=gen, device="cuda") for _ in range(2)]
    if ex.y_plan == "dense":
        return [(f"{name}/expand", rnd(S), ex._yx_map), (f"{name}/pack", rnd(Y * A), ex._stick_keys)]
    if ex.y_plan == "blocked":
        rows = ex._bucket_rows.numel()
        return [(f"{name}/bucket_gather", rnd(S), ex._bucket_rows),
                (f"{name}/regather", rnd(rows), ex._row_of_stick)]
    return []


def storage(idx, dim):
    return np.where(idx < 0, idx + dim, idx)


def oracle(kind, radius):
    """Triplets, values and the complex128 dense oracle of the backward
    transform of one (transform, radius)."""
    import spfft_tpu_torch as sp

    Z, Y, X = DIMS[2], DIMS[1], DIMS[0]
    N = X * Y * Z
    rng = np.random.default_rng(SEED)
    triplets = sp.create_spherical_cutoff_triplets(*DIMS, radius, hermitian_symmetry=kind == "r2c")
    if kind == "c2c":
        values = rng.standard_normal(len(triplets)) + 1j * rng.standard_normal(len(triplets))
        dense = np.zeros((Z, Y, X), np.complex128)
        t3 = np.asarray(triplets)
        dense[storage(t3[:, 2], Z), storage(t3[:, 1], Y), storage(t3[:, 0], X)] = values
        want = np.fft.ifftn(dense) * N
    else:
        # hermitian-consistent values: the spectrum of a real field, cut to the
        # sphere (symmetric under k -> -k, no Nyquist plane at this radius)
        spectrum = np.fft.fftn(rng.standard_normal((Z, Y, X)))
        tf = np.asarray(sp.create_spherical_cutoff_triplets(*DIMS, radius))
        zf, yf, xf = storage(tf[:, 2], Z), storage(tf[:, 1], Y), storage(tf[:, 0], X)
        dense = np.zeros((Z, Y, X), np.complex128)
        dense[zf, yf, xf] = spectrum[zf, yf, xf]
        want = (np.fft.ifftn(dense) * N).real
        th = np.asarray(triplets)
        values = spectrum[storage(th[:, 2], Z), storage(th[:, 1], Y), th[:, 0]]
        del spectrum
    del dense
    return triplets, values, want


def expected_launches(ex) -> tuple[int, int]:
    """(K1, K2) launches of one backward+forward pair of the engine's y plan."""
    if ex.y_plan == "dense":
        return 6, 2
    if ex.y_plan == "per-slot":
        return 6, 0
    return 2 * len(ex.buckets) + 4, 2


def launch_counts():
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import row_gather as k2

    return {"complex_matmul": dict(k1.launches), "row_gather": dict(k2.launches)}


def clear_counts() -> None:
    from spfft_tpu_torch import ir
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import row_gather as k2

    k1.launches.clear()
    k2.launches.clear()
    ir.dispatches.clear()


def run_pair(sp, t, values_dev) -> dict:
    """One backward + forward(FULL) through the entry points, counted from 0;
    the launch and dispatch counts of that pair, its results, and the most
    memory it held above what was allocated before it."""
    import torch
    from spfft_tpu_torch import ir

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    clear_counts()
    space = t.backward(values_dev)
    back = t.forward(scaling=sp.ScalingType.FULL)
    torch.cuda.synchronize()
    return {"counts": launch_counts(), "dispatches": {f"{m}:{d}": n for (m, d), n in
                                                      ir.dispatches.items()},
            "space": space, "back": back,
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - before}


def total(counts) -> int:
    return sum(sum(c.values()) for c in counts.values())


def equal(a, b) -> tuple[bool, float]:
    """(bitwise equal, max abs diff) of two tensors on the card."""
    import torch

    return torch.equal(a, b), float((a - b).abs().max().item())


def copy_out_ms(t) -> dict:
    """Device time of the copies a fused call hands out: the static outputs
    of the backward and forward(FULL) graphs, cloned."""
    import spfft_tpu_torch as sp

    programs = t._exec._ir._programs
    out = {}
    for key, label in ((("backward", None, None), "backward"),
                       (("forward", sp.ScalingType.FULL, None), "forward")):
        static = programs[key]._captured[2]
        static = static if isinstance(static, tuple) else (static,)
        out[label] = device_ms(lambda: [o.clone() for o in static])
        out[label + "_bytes"] = sum(2 * o.numel() * o.element_size() for o in static)
    return out


def main_path(sp, name, t, twin, precision, values, want):
    """The main path of one plan: its staged twin's pair (each launch counts
    once: the launch counts of the kernels line), then the fused plan's first
    pair (warm-up and capture: exactly twice the twin's launches) and second
    pair (replays: no launch on the host), each against the dense oracle and
    bitwise against the twin. Returns the twin's launch counts and the
    device values."""
    import torch

    f64 = t.dtype == np.float64
    values_dev = torch.as_tensor(values.astype(np.complex128 if f64 else np.complex64),
                                 device="cuda")
    staged = run_pair(sp, twin, values_dev)
    first = run_pair(sp, t, values_dev)
    second = run_pair(sp, t, values_dev)

    Z, Y, X = DIMS[2], DIMS[1], DIMS[0]
    space_h = first["space"].cpu().numpy()
    check(space_h.shape == (Z, Y, X) and np.isfinite(space_h).all(), f"{name} space shape/finite")
    back_h = first["back"].cpu().numpy()
    check(back_h.shape == (len(values),) and np.isfinite(back_h).all(), f"{name} values shape/finite")
    oracle_err = float(np.abs(space_h - want).max() / np.abs(want).max())
    rt_err = float(np.abs(back_h - values).max() / np.abs(values).max())
    counts = staged["counts"]
    n_k1, n_k2 = sum(counts["complex_matmul"].values()), sum(counts["row_gather"].values())
    precisions = sorted({key[-1] for key in counts["complex_matmul"]})
    ex = t._exec
    twice = {k: {key: 2 * n for key, n in c.items()} for k, c in counts.items()}
    vs_staged = {part: equal(first[part], staged[part]) for part in ("space", "back")}
    replay_same = all(equal(second[part], first[part])[0] for part in ("space", "back"))
    row = {
        "phase": "main_path", "plan": name, "engine": t.engine,
        "transform": t.transform_type.name.lower(), "dims": list(DIMS), "dtype": str(t.dtype),
        "precision": precision, "y_plan": getattr(ex, "y_plan", None), "describe": t.describe(),
        "num_values": len(values), "num_sticks": t.params.num_sticks,
        "num_x_active": t.num_x_active, "oracle_rel_err": oracle_err, "roundtrip_rel_err": rt_err,
        "bar": ORACLE_F64_RTOL if f64 else ORACLE_RTOL[precision],
        "launches": {"complex_matmul": n_k1, "row_gather": n_k2, "from": "the staged twin's pair"},
        "launches_first_fused_pair": total(first["counts"]),
        "launches_second_fused_pair": total(second["counts"]),
        "dispatches": {"staged": staged["dispatches"], "fused_first": first["dispatches"],
                       "fused_second": second["dispatches"]},
        "fused_vs_staged": {p: {"bitwise": b, "max_abs_diff": d} for p, (b, d) in vs_staged.items()},
        "k1_precisions": precisions,
        "peak_extra_bytes": {"staged_pair": staged["peak_extra_bytes"],
                             "fused_first_pair": first["peak_extra_bytes"],
                             "fused_pair": second["peak_extra_bytes"]},
        "copy_out_ms": copy_out_ms(t),
    }
    emit(row)
    bar = row["bar"]
    check(t.fused and not twin.fused, f"{name}: the plan is not fused or its twin not staged")
    check(oracle_err <= bar, f"{name} backward vs dense oracle: {oracle_err} (bar {bar})")
    check(rt_err <= bar, f"{name} round trip: {rt_err} (bar {bar})")
    check(all(b for b, _ in vs_staged.values()),
          f"{name}: fused and staged results differ: {vs_staged}")
    check(replay_same, f"{name}: the replayed pair differs from the captured one")
    check(second["dispatches"] == {"fused:backward": 1, "fused:forward": 1},
          f"{name}: fused dispatches {second['dispatches']}")
    check(total(second["counts"]) == 0, f"{name}: a replayed pair launched on the host")
    if t.engine == "xla":
        check(total(counts) == 0 and total(first["counts"]) == 0, f"{name} launched K1 or K2")
        return counts, values_dev
    check(first["counts"] == twice,
          f"{name}: first fused pair launched {first['counts']}, not twice the twin's {counts}")
    want_k1, want_k2 = expected_launches(ex)
    check(n_k1 == want_k1 and n_k2 == want_k2,
          f"{name} launches: {n_k1} K1, {n_k2} K2 (expected {want_k1} and {want_k2})")
    check(precisions == [precision], f"{name} ran K1 at {precisions}, not {precision}")
    return counts, values_dev


def results_stay_put(sp, name, t, values_dev) -> None:
    """Two backwards on different values: the first one's results, native
    (``backward_pair``) and public, are unchanged after the second."""
    import torch

    other = values_dev.roll(1) * (0.5 - 0.25j)
    native = t.backward_pair(values_dev.real, values_dev.imag)
    native = native if isinstance(native, tuple) else (native,)
    kept_native = [x.clone() for x in native]
    public = t.backward(values_dev)
    kept_public = public.clone()
    later = t.backward_pair(other.real, other.imag)
    later = later if isinstance(later, tuple) else (later,)
    t.backward(other)
    torch.cuda.synchronize()
    stayed = all(torch.equal(a, b) for a, b in zip(native, kept_native)) and torch.equal(
        public, kept_public)
    differ = not torch.equal(later[0], native[0])
    emit({"phase": "results_stay_put", "plan": name, "stayed": stayed,
          "second_result_differs": differ})
    check(stayed and differ, f"{name}: a result changed after a later call")


def batch_phase(sp, name, t, values_dev, rounds: int = 6) -> dict:
    """``backward_batch``/``forward_batch(FULL)`` of ``BATCH`` requests
    against the per-request calls: bitwise equal, one batched dispatch per
    direction; then ms per transform, batch against a loop of single pairs,
    the two taking turns."""
    import torch
    from spfft_tpu_torch import ir

    full = sp.ScalingType.FULL
    vals = [values_dev.roll(b) for b in range(BATCH)]
    singles = [t.backward(v).clone() for v in vals]
    fsingles = [t.forward(s, full) for s in singles]
    torch.cuda.synchronize()
    ir.dispatches.clear()
    spaces = t.backward_batch(vals)
    freqs = t.forward_batch(spaces, full)
    torch.cuda.synchronize()
    dispatches = {f"{m}:{d}": n for (m, d), n in ir.dispatches.items()}
    same = [equal(a, b) for a, b in zip(spaces + freqs, singles + fsingles)]

    def batch():
        t.forward_batch(t.backward_batch(vals), full)

    def loop():
        for v in vals:
            t.forward(t.backward(v), full)

    times = {"batch": [], "loop": []}
    for r in range(rounds):
        for label, fn in (("batch", batch), ("loop", loop))[::1 if r % 2 == 0 else -1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label].append(1e3 * (time.perf_counter() - t0) / BATCH)
    row = {"phase": "batch", "plan": name, "batch": BATCH, "dispatches": dispatches,
           "bitwise_equal_to_single_calls": all(b for b, _ in same),
           "max_abs_diff": max(d for _, d in same),
           "ms_per_transform_pair": {k: statistics.median(v) for k, v in times.items()},
           "timing": f"host clock, median of {rounds} turns; both forwards read the "
                     "(Z, Y, X) spaces their backwards returned"}
    emit(row)
    check(dispatches == {"batched:backward": 1, "batched:forward": 1},
          f"{name}: batch dispatches {dispatches}")
    check(row["bitwise_equal_to_single_calls"], f"{name}: batch differs from single calls")
    return row


def multi_transform_phase(sp, names, plans, values) -> None:
    """The headline C2C and R2C plans in one multi-transform batch, against
    their single calls."""
    import torch

    ts = [plans[n][0] for n in names]
    vals = [values[n] for n in names]
    singles = [t.backward(v).clone() for t, v in zip(ts, vals)]
    fsingles = [t.forward(scaling=sp.ScalingType.FULL) for t in ts]
    spaces = sp.multi_transform_backward(ts, vals)
    freqs = sp.multi_transform_forward(ts, None, sp.ScalingType.FULL)
    torch.cuda.synchronize()
    same = [equal(a, b) for a, b in zip(spaces + freqs, singles + fsingles)]
    emit({"phase": "multi_transform", "plans": list(names),
          "bitwise_equal_to_single_calls": all(b for b, _ in same),
          "max_abs_diff": max(d for _, d in same)})
    check(all(b for b, _ in same), "multi-transform results differ from the single calls")


def interleaved_pair_ms(sp, plans, values, rounds: int = 6, pairs: int = 4) -> dict:
    """Median ms per backward+forward(FULL) pair of every plan (``plans``:
    name -> Transform), host clock, the plans taking turns (forward order,
    then reversed, ``rounds`` times, ``pairs`` timed pairs after one untimed
    pair at each turn), so that the host's drift falls on all of them alike."""
    import torch

    times = {name: [] for name in plans}
    for r in range(rounds):
        for name in (list(plans) if r % 2 == 0 else list(reversed(plans))):
            t = plans[name]
            for i in range(pairs + 1):
                t0 = time.perf_counter()
                t.backward(values[name])
                t.forward(scaling=sp.ScalingType.FULL)
                torch.cuda.synchronize()
                if i:
                    times[name].append(1e3 * (time.perf_counter() - t0))
    return {name: statistics.median(v) for name, v in times.items()}


def profile_pair(sp, name, t, values_dev) -> dict:
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
        short = e.name if len(e.name) <= 90 else e.name[:87] + "..."
        ms, n = by_name.get(short, (0.0, 0))
        by_name[short] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    of = lambda *keys: sum((e.time_range.end - e.time_range.start) / 1e3 for e in kernels
                           if any(k in e.name for k in keys))
    row = {
        "phase": "profile", "plan": name, "window_ms": window_ms,
        "device_busy_ms": busy_us / 1e3 if spans else None,
        "device_busy_share": busy_us / 1e3 / window_ms if spans else None,
        "k1_ms": of("tc_kernel", "dmma_kernel"), "k2_ms": of("row_gather_kernel"),
        "nccl_ms": of("ncclDevKernel"), "kernels": len(kernels),
        "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top],
    }
    emit(row)
    return row


# ---- the distributed phase -------------------------------------------------------


def dist_k1_forms(name, t):
    """The K1 forms of distributed plan ``name`` that get a row: its z stages,
    stacked over the four shards with the z-slab split in their matrices
    (``(P_local * S_max, Z) @ (Z, P * L_max)`` and back); for a plan whose
    slab side differs from the local plan's (ragged slabs: z extent
    P_local * L_max = 280; float64), also its x and y forms."""
    import torch
    from spfft_tpu_torch import ScalingType

    FULL = ScalingType.FULL
    ex, p = t._exec, t.params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dt = ex.torch_dtype
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=dt)
    pair = lambda *shape: (rnd(*shape), rnd(*shape))
    rows, PL = ex.num_local * ex._S, p.num_shards * ex._L
    if PL == p.dim_z:  # both directions at one shape: one launch key, so one row
        forms = [(f"{name}/z_backward+forward", "sz,zk->sk", pair(rows, p.dim_z), ex._wz_b,
                  True, None)]
    else:
        forms = [(f"{name}/z_backward", "sz,zk->sk", pair(rows, p.dim_z), ex._wz_b, True, None),
                 (f"{name}/z_forward", "sz,zk->sk", pair(rows, PL), ex._wz_f[FULL], True, None)]
    if ex._zs == p.dim_z and dt == torch.float32:
        return forms
    Y, A, X, Zs = p.dim_y, ex.num_x_active, p.dim_x, ex._zs
    forms += [(f"{name}/x_backward", "kxz,xl->klz", pair(Y, A, Zs), ex._wx_b, True, None),
              (f"{name}/x_forward", "yxz,xk->ykz", pair(Y, X, Zs), ex._wx_f, True, None)]
    grid, col = pair(Y, A, Zs), 0
    for b, (ag, syg, wb, wf) in enumerate(ex.buckets):
        cols = tuple(g[:, col:col + ag] for g in grid)
        forms.append((f"{name}/bucket{b}_backward", SLOTS_OUT, pair(ag, syg, Zs), wb, True, cols))
        forms.append((f"{name}/bucket{b}_forward", SLOTS_IN, cols, wf, True, None))
        col += ag
    return forms


def dist_k2_forms(name, t, gen):
    """The exchange's K2 gathers of distributed plan ``name``: (row name,
    source planes, index, packed). Without a group one gather per direction;
    over the process group a pack gather per direction into the send
    buffer's column blocks and an unpack gather out of the received one's."""
    import torch

    ex = t._exec
    xc = ex._exchange
    planes = 1 if t.engine == "xla" else 2
    width = xc.L * (2 if t.engine == "xla" else 1)
    rnd = lambda rows: [torch.randn((rows, width), generator=gen, device="cuda",
                                    dtype=ex.torch_dtype) for _ in range(planes)]
    sticks, slots = xc.Pl * xc.S * xc.P, xc.num_fwd_slots * xc.Pl
    if not xc.collective:
        return [(f"{name}/exchange_backward", rnd(sticks), xc._bwd_index, False),
                (f"{name}/exchange_forward", rnd(slots), xc._fwd_index, False)]

    def received(rows):
        buf = torch.randn((rows, planes * width), generator=gen, device="cuda",
                          dtype=ex.torch_dtype)
        return [buf[:, q * width:(q + 1) * width] for q in range(planes)]

    return [(f"{name}/pack_backward", rnd(sticks), xc._bwd[0], True),
            (f"{name}/unpack_backward", received(sum(xc._bwd[3])), xc._bwd[1], False),
            (f"{name}/pack_forward", rnd(slots), xc._fwd[0], True),
            (f"{name}/unpack_forward", received(sum(xc._fwd[3])), xc._fwd[1], False)]


def shard_index(triplets, per):
    """Per shard, the positions of its triplets in the global array."""
    key = lambda t: ((t[:, 0] + 1024) * 2048 + t[:, 1] + 1024) * 2048 + t[:, 2] + 1024
    keys = key(np.asarray(triplets, np.int64))
    order = np.argsort(keys)
    return [order[np.searchsorted(keys[order], key(np.asarray(t, np.int64)))] for t in per]


def expected_dist_launches(t) -> tuple[int, int]:
    """(K1, K2) launches of one distributed pair: the local engine's K1
    stages; K2 one exchange gather per direction, or a pack and an unpack
    per direction over a process group."""
    k2 = 4 if t._exec._exchange.collective else 2
    return (0, k2) if t.engine == "xla" else (expected_launches(t._exec)[0], k2)


def dist_main_path(sp, name, t, twin, values, want, local_space, local_back, bar, ref=None):
    """The main path of one distributed plan: the staged twin's pair (the
    launch counts), the fused plan's first pair (twice the twin's launches)
    and second (none), against the dense oracle, the local plan's backward,
    the input values (round trip) and bitwise against the twin; the plan
    over the process group (staged, no twin) bitwise against ``ref``, the
    pair of the same plan without a group. Returns the launch counts, the
    pair's results and the row."""
    import torch

    staged = run_pair(sp, twin, values)
    first = run_pair(sp, t, values) if t is not twin else staged
    second = run_pair(sp, t, values) if t is not twin else staged
    space_h = first["space"].cpu().numpy()
    check(space_h.shape == want.shape and np.isfinite(space_h).all(), f"{name} space shape/finite")
    back = first["back"]
    check(len(back) == 4 and all(bool(torch.isfinite(b).all()) for b in back),
          f"{name} values finite")
    oracle_err = float(np.abs(space_h - want).max() / np.abs(want).max())
    local_err = float(np.abs(space_h - local_space).max() / np.abs(local_space).max())
    scale = max(float(v.abs().max()) for v in values)
    rt_err = max(float((b - v).abs().max()) for b, v in zip(back, values)) / scale
    local_back_err = max(float((b.to(lb.dtype) - lb).abs().max())
                         for b, lb in zip(back, local_back)) / scale
    counts = staged["counts"]
    n_k1, n_k2 = (sum(counts[k].values()) for k in ("complex_matmul", "row_gather"))
    twice = {k: {key: 2 * n for key, n in c.items()} for k, c in counts.items()}
    same = lambda a, b: torch.equal(a["space"], b["space"]) and all(
        torch.equal(x, y) for x, y in zip(a["back"], b["back"]))
    ex = t._exec
    row = {
        "phase": "dist_main_path", "plan": name, "engine": t.engine, "dims": list(DIMS),
        "transform": t.transform_type.name.lower(), "dtype": str(np.dtype(t.dtype)),
        "exchange": t.exchange_type.name,
        "exchange_requested": t.describe()["exchange"]["requested"],
        "exchange_wire_bytes": t.exchange_wire_bytes(), "exchange_rounds": t.exchange_rounds(),
        "transport": ex.exchange_transport(), "fused": t.fused,
        "staged_because": t.describe()["ir"].get("staged_because"),
        "y_plan": getattr(ex, "y_plan", None), "describe": t.describe(),
        "num_sticks_per_shard": [int(n) for n in t.params.num_sticks_per_shard],
        "local_z_lengths": [int(n) for n in t.params.local_z_lengths],
        "oracle_rel_err": oracle_err, "local_plan_rel_err": local_err,
        "local_plan_values_rel_err": local_back_err, "roundtrip_rel_err": rt_err, "bar": bar,
        "launches": {"complex_matmul": n_k1, "row_gather": n_k2,
                     "from": "the staged pair" if t is twin else "the staged twin's pair"},
        "launches_first_fused_pair": total(first["counts"]),
        "launches_second_fused_pair": total(second["counts"]),
        "dispatches": {"staged": staged["dispatches"], "fused_second": second["dispatches"]},
        "fused_equals_staged": same(first, staged),
        "peak_extra_bytes": {"staged_pair": staged["peak_extra_bytes"],
                             "fused_pair": second["peak_extra_bytes"]},
    }
    if ref is not None:
        row["bitwise_equal_to_the_plan_without_a_group"] = same(staged, ref)
    emit(row)
    check(oracle_err <= bar, f"{name} backward vs dense oracle: {oracle_err} (bar {bar})")
    check(rt_err <= bar, f"{name} round trip: {rt_err} (bar {bar})")
    check(local_err <= ORACLE_RTOL["highest"], f"{name} vs the local plan: {local_err}")
    check(local_back_err <= ORACLE_RTOL["highest"],
          f"{name} values vs the local plan: {local_back_err}")
    want_k1, want_k2 = expected_dist_launches(t)
    check(n_k1 == want_k1 and n_k2 == want_k2,
          f"{name} launches: {n_k1} K1, {n_k2} K2 (expected {want_k1} and {want_k2})")
    if ref is not None:
        check(not t.fused and row["bitwise_equal_to_the_plan_without_a_group"],
              f"{name}: not staged, or not bitwise equal to the plan without a group")
    else:
        check(t.fused and not twin.fused, f"{name}: the plan is not fused or its twin not staged")
        check(row["fused_equals_staged"], f"{name}: fused and staged results differ")
        check(first["counts"] == twice, f"{name}: first fused pair launched {first['counts']}, "
              f"not twice the twin's {counts}")
        check(total(second["counts"]) == 0, f"{name}: a replayed pair launched on the host")
        check(second["dispatches"] == {"fused:backward": 1, "fused:forward": 1},
              f"{name}: fused dispatches {second['dispatches']}")
    return counts, staged, row


def dist_phase(sp, data, plans, values):
    """Builds and drives every plan of ``DIST_PLANS`` (see the module
    docstring), each against its oracle and local plan. Returns the plans
    {name: (plan, twin or None)}, their launch counts, their kernel rows and
    their per-shard values."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    with socket.socket() as sock:  # a free port for the group's rendezvous
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    group = sp.init_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    local_results = {}
    for local in {d[-1] for d in DIST_PLANS}:
        lt = plans[local][0]
        local_results[local] = (lt.backward(values[local]).cpu().numpy(),
                                lt.forward(scaling=sp.ScalingType.FULL))
    out, counts, rows, dvalues, mains = {}, {}, [], {}, {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for name, kind, engine, exchange, dtype, weights, lz, over_group, local in DIST_PLANS:
        triplets, vals_global, want = data[kind, 0.659]
        per = sp.distribute_triplets(triplets, 4, DIMS[1], weights=weights)
        where = shard_index(triplets, per)
        cdt = np.complex64 if dtype == np.float32 else np.complex128
        vals = [torch.as_tensor(vals_global[i].astype(cdt), device="cuda") for i in where]
        mesh = sp.make_fft_mesh(4, group=group if over_group else None)
        make = lambda **kw: sp.DistributedTransform(
            sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()), *DIMS, per,
            mesh=mesh, engine=engine, exchange_type=getattr(sp.ExchangeType, exchange),
            dtype=dtype, local_z_lengths=lz, **kw)
        t = make()
        twin = t if over_group else make(fuse=False)
        emit({"phase": "dist_plan", "plan": name, "engine": t.engine, "fused": t.fused,
              "exchange": t.exchange_type.name, "describe": t.describe()})
        if engine == "auto":
            check(t.engine == "mxu", f"{name}: auto resolved to {t.engine} on the card")
        if t.engine == "mxu":
            got = [(ag, syg) for ag, syg, _, _ in t._exec.buckets] if t._exec.buckets else None
            check(t._exec.y_plan == "blocked" and got == EXPECT[kind, 0.659],
                  f"{name}: y plan {t._exec.y_plan} {got}, not the blocked {EXPECT[kind, 0.659]}")
        # the kernels at this plan's forms, against their plain versions
        if t.engine == "mxu" and not over_group:
            for form, spec, x, w, want_imag, o in dist_k1_forms(name, t):
                row, key = run_k1(form, spec, x, w, want_imag, t.precision, o)
                rows.append((row, name, "complex_matmul", key))
        for form, src, idx, packed in dist_k2_forms(name, t, gen):
            row, key = run_k2(form, src, idx, packed)
            rows.append((row, name, "row_gather", key))
        bar = DIST_F64_RTOL if dtype == np.float64 else ORACLE_RTOL["highest"]
        local_space, local_back = local_results[local]
        local_back = [local_back[torch.as_tensor(i, device="cuda")] for i in where]
        ref = mains["dist4-c2c"] if over_group else None
        counts[name], mains[name], _ = dist_main_path(
            sp, name, t, twin, vals, want, local_space, local_back, bar, ref)
        out[name], dvalues[name] = (t, None if over_group else twin), vals
    return out, counts, rows, dvalues, dist


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    _build.build_all(LIBRARIES)
    report = build_report(LIBRARIES)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, **report})
    for name in LIBRARIES[:3]:
        check(report[name]["sass_hgmma"] > 0, f"{name} has no HGMMA instruction")
    # the float64 body runs on the FP64 tensor cores
    check(report["complex_matmul_f64"]["sass_dmma"] > 0, "complex_matmul_f64 has no DMMA instruction")
    # each library runs its precision's arithmetic: TF32 for "highest", BF16 below
    check(report["complex_matmul"]["sass_hgmma_bf16"] == 0, "complex_matmul has BF16 HGMMA")
    for name in LIBRARIES[1:3]:
        check(report[name]["sass_hgmma_bf16"] > 0, f"{name} has no BF16 HGMMA instruction")

    # ---- the plans: each y variant as the JAX package's planner makes it ----
    # every plan fused (the default) with a fuse=False twin under name + STAGED
    t0 = time.perf_counter()
    data, plans, twins = {}, {}, {}
    make = lambda kind, radius, dtype=F32, **kw: sp.Transform(
        sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()), *DIMS,
        indices=data[kind, radius][0], dtype=dtype, **kw)
    for name, kind, radius, precision, env, y_plan, dtype in PLANS:
        if (kind, radius) not in data:
            data[kind, radius] = oracle(kind, radius)
        with knobs(env):
            t = make(kind, radius, dtype, precision=precision)
            twins[name] = make(kind, radius, dtype, precision=precision, fuse=False)
        ex = t._exec
        got = ex.sy if ex.y_plan == "per-slot" else (
            [(ag, syg) for ag, syg, _, _ in ex.buckets] if ex.y_plan == "blocked" else None)
        emit({"phase": "plan", "plan": name, "precision": precision, "dtype": str(t.dtype),
              "y_plan": ex.y_plan,
              "num_sticks": t.params.num_sticks, "num_x_active": t.num_x_active,
              "buckets_or_sy": got, "describe": t.describe()})
        check(t.engine == "mxu", f"{name}: auto resolved to {t.engine} on the card")
        check(ex.y_plan == y_plan and twins[name]._exec.y_plan == y_plan,
              f"{name} engaged {ex.y_plan}, not {y_plan}")
        if y_plan != "dense":
            check(got == EXPECT[kind, radius], f"{name}: {got}, not {EXPECT[kind, radius]}")
        plans[name] = (t, precision, (kind, radius))
    for name, kind, radius in XLA_PLANS:
        t = make(kind, radius, engine="xla")
        twins[name] = make(kind, radius, engine="xla", fuse=False)
        emit({"phase": "plan", "plan": name, "engine": "xla", "describe": t.describe()})
        plans[name] = (t, "highest", (kind, radius))
    emit({"phase": "plans", "seconds": time.perf_counter() - t0})

    # ---- kernels against their plain versions, at the main path's shapes ----
    rows = []  # (row, plan, kernel, launch-count key)
    for name, (t, precision, _) in plans.items():
        if t.engine != "mxu":
            continue
        for form, spec, x, w, want_imag, out in k1_forms(name, t):
            row, key = run_k1(form, spec, x, w, want_imag, precision, out)
            rows.append((row, name, "complex_matmul", key))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for name in ("c2c", "r2c", "c2c-blocked", "r2c-blocked", "c2c-r0.5-dense"):
        for form, src, idx in k2_forms(name, plans[name][0], gen):
            row, key = run_k2(form, src, idx)
            rows.append((row, name, "row_gather", key))
    for precision in ("highest", "high", "default"):
        run_k1_odd(f"kernel_f32_odd_{precision}", torch.float32, K1_RTOL, precision)
    run_k1_odd("kernel_f64", torch.float64, K1_F64_RTOL)

    # ---- the main path, every plan and its twin with the counts set to 0 just before ----
    counts, values = {}, {}
    for name, (t, precision, key) in plans.items():
        _, vals, want = data[key]
        counts[name], values[name] = main_path(sp, name, t, twins[name], precision, vals, want)
    for name in ("c2c-blocked", "r2c-blocked"):
        results_stay_put(sp, name, plans[name][0], values[name])
    batches = {name: batch_phase(sp, name, plans[name][0], values[name])
               for name in ("c2c-blocked", "r2c-blocked")}
    multi_transform_phase(sp, ("c2c-blocked", "r2c-blocked"), plans, values)

    # ---- the distributed phase: four shards on the card, and over a process group ----
    t0 = time.perf_counter()
    dplans, dcounts, drows, dvalues, dist = dist_phase(sp, data, plans, values)
    del data
    rows += drows
    counts.update(dcounts)
    values.update(dvalues)
    emit({"phase": "dist", "seconds": time.perf_counter() - t0})

    # ---- the profile, and the pair times with every plan and twin taking turns ----
    every = {**{n: v[0] for n, v in plans.items()}, **{n + STAGED: t for n, t in twins.items()},
             **{n: t for n, (t, _) in dplans.items()},
             **{n + STAGED: tw for n, (_, tw) in dplans.items() if tw is not None}}
    values.update({n + STAGED: values[n] for n in twins})
    values.update({n + STAGED: dvalues[n] for n, (_, tw) in dplans.items() if tw is not None})
    busy = {name: profile_pair(sp, name, t, values[name]) for name, t in every.items()}
    turns = interleaved_pair_ms(sp, every, values)
    emit({"phase": "compare", "what": "median ms per pair (host clock), all plans and their "
          "staged twins taking turns (6 rounds, 4 timed pairs per turn); device busy ms and "
          "K1/K2 ms of one profiled pair; same run", **{
              name: {"pair_ms_in_turns": turns[name], "device_busy_ms": busy[name]["device_busy_ms"],
                     "staged_pair_ms_in_turns": turns[name + STAGED],
                     "staged_device_busy_ms": busy[name + STAGED]["device_busy_ms"],
                     "k1_ms": busy[name]["k1_ms"], "k2_ms": busy[name]["k2_ms"],
                     "kernels": busy[name]["kernels"],
                     "staged_kernels": busy[name + STAGED]["kernels"]}
              for name in plans},
          "batch_ms_per_transform_pair": {n: b["ms_per_transform_pair"] for n, b in batches.items()}})
    dist_rows = {}
    for name, *_, local in DIST_PLANS:
        tw = name + STAGED if name + STAGED in turns else None
        dist_rows[name] = {
            "pair_ms_in_turns": turns[name], "device_busy_ms": busy[name]["device_busy_ms"],
            "staged_pair_ms_in_turns": turns[tw] if tw else None,
            "staged_device_busy_ms": busy[tw]["device_busy_ms"] if tw else None,
            "k1_ms": busy[name]["k1_ms"], "exchange_k2_ms": busy[name]["k2_ms"],
            "nccl_ms": busy[name]["nccl_ms"], "kernels": busy[name]["kernels"],
            "local_plan": local, "local_pair_ms_in_turns": turns[local],
            "local_device_busy_ms": busy[local]["device_busy_ms"],
            "pair_vs_local": turns[name] / turns[local],
            "busy_vs_local": busy[name]["device_busy_ms"] / busy[local]["device_busy_ms"],
        }
    emit({"phase": "compare_dist", "what": "the distributed plans against the local blocked "
          "plan of the same triplets: median ms per pair (host clock, in the same turns as "
          "the compare line), device busy ms of one profiled pair; exchange_k2_ms is the "
          "exchange's K2 gathers, nccl_ms its collective kernels", **dist_rows})

    kernels = []
    for row, name, kernel, key in rows:
        launches = counts[name][kernel].get(key, 0)
        check(launches > 0, f"{row['name']} was not launched by the main path of {name}")
        kernels.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "call_ms", "bound_share")}
            | {"launches": launches}
            | {k: row[k] for k in ("precision", "fp32_bound_ms", "library_math", "library_tf32_ms")
               if k in row})
    dist.destroy_process_group()
    emit({"phase": "done", "seconds": time.perf_counter() - started})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
