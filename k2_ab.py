#!/usr/bin/env python3
"""K2 (``row_gather``) against the designs it was chosen from, on one CUDA card.

Run from the root of a checkout, on a machine with an H100 and the CUDA toolkit:

    python3 k2_ab.py [--against DIR] [--out FILE]

For every K2 form of ``chip_smoke.py``'s 256^3 plans (local dense and
blocked C2C and R2C; the 4-shard mesh plans, skewed and float64 among them)
and of ``BASELINE.json``'s five configurations (``chip_smoke.BENCH_CONFIGS``
at one repeat), in one process and on the same operands, it times:

- ``this``: this tree's kernel, ``spfft_tpu_torch/csrc/row_gather.cu``;
- ``against``: ``DIR/spfft_tpu_torch/csrc/row_gather.cu``, another tree's
  kernel (e.g. the parent commit unpacked with ``git archive``);
- the designs tried beside it (``VARIANTS``, built from ``VARIANT_SOURCE``
  with the same C entry and vector rule): U vectors' loads in flight a
  thread before their stores, on short-lived blocks or on a persistent grid
  (the SMs times the resident blocks), the row of a vector by 32-bit
  division, and a ring of bulk (TMA) copies through shared memory for rows
  of 1 KB and more (``bulk-ring``; on narrower rows it is ``flat-u1``);
  ``flat-u1`` is this tree's design built again, the A/A control;
- ``index_select``: one ``torch.index_select`` on the two planes stacked
  and padded with a zero row, into an output of its own per copy of the
  operands, the library call of ``chip_smoke.py``'s rows;
- ``floor``: an empty kernel of one block.

Each by two clocks: ``replay``, ``chip_smoke.device_ms`` (one call captured
in a CUDA graph, the graph replayed 20 times by the host between two
events: what ``chip_smoke.py``'s K1 rows and K2 ``replay_ms`` read); and
``graph``, ``chip_smoke.graph_ms`` (20 calls captured in one graph,
replayed three times, over ``chip_smoke.l2_copies`` copies of the
operands, as many as hold twice the card's L2 cache, so that no host
replay and little of L2 stands in the time: what K2's ``ms`` reads). Three rounds, in turn
order forward, backward, forward; per form the least and the median of the
rounds. Every kernel's output is held bitwise against ``row_gather_plain``
first. One JSON line per form, with ``bound_ms`` (bytes over 3.35 TB/s, as
in ``chip_smoke.run_k2``) and each kernel's share of it; the lines also go
to ``--out``. Exits non-zero without a CUDA device or if a kernel disagrees.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import io
import json
import os
import subprocess
import sys

import chip_smoke as cs

OUT_DIR = os.path.join("build", "k2_ab")
ROUNDS = 3

# The designs beside csrc/row_gather.cu, with its C entry (spfft_row_gather)
# and its rule for the vector (16, 8 or 4 bytes). A thread takes UNROLL
# vectors, THREADS apart, loads all of them, then stores them. PERSISTENT:
# the grid is the SMs times the blocks resident on one (the occupancy
# query), striding over tiles of THREADS x UNROLL vectors; else one block a
# tile. DIV32: the row of a vector by 32-bit division where the vectors
# number under 2^32. BULK: rows of 1 KB and more in 16-byte vectors go
# through the Tensor Memory Accelerator instead: each warp of a persistent
# grid walks rows a grid apart, and its first lane keeps BULK_STAGES rows'
# bulk loads (cp.async.bulk, global to shared, under one mbarrier a slot) in
# flight and copies each landed row out with a bulk store (shared to
# global); a row with an out-of-range index is written as zeros by the
# warp's lanes. k2ab_floor launches an empty kernel of one block.
VARIANT_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
#if BULK
#include "sm90.cuh"
#endif

namespace {

constexpr int THREADS = 256;

struct Args {
  const char* src_re;
  const char* src_im;
  char* out_re;
  char* out_im;
  const int32_t* idx;
  int64_t n_rows, n_src;
  int64_t row_bytes, ld_src, ld_out;
};

template <typename V>
__global__ void __launch_bounds__(THREADS) gather(
    const V* __restrict__ src_re, const V* __restrict__ src_im, V* __restrict__ out_re,
    V* __restrict__ out_im, const int32_t* __restrict__ idx, int64_t n_rows, int64_t n_src,
    int64_t chunks, int64_t ld_src, int64_t ld_out) {
  const bool two = out_im != nullptr;
  const int64_t total = n_rows * chunks;
  const bool narrow = DIV32 && total <= 0xffffffffll;
  constexpr int64_t TILE = static_cast<int64_t>(THREADS) * UNROLL;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * TILE; base < total;
       base += static_cast<int64_t>(gridDim.x) * TILE) {
    V a[UNROLL], b[UNROLL];
    int64_t at[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t v = base + threadIdx.x + static_cast<int64_t>(k) * THREADS;
      a[k] = V{};
      b[k] = V{};
      at[k] = -1;
      if (v < total) {
        const int64_t r = narrow ? static_cast<int64_t>(static_cast<uint32_t>(v) /
                                                        static_cast<uint32_t>(chunks))
                                 : v / chunks;
        const int64_t c = v - r * chunks;
        const int64_t s = __ldg(idx + r);
        if (s >= 0 && s < n_src) {
          a[k] = __ldg(src_re + s * ld_src + c);
          if (two) b[k] = __ldg(src_im + s * ld_src + c);
        }
        at[k] = r * ld_out + c;
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (at[k] >= 0) {
        __stcs(out_re + at[k], a[k]);
        if (two) __stcs(out_im + at[k], b[k]);
      }
    }
  }
}

__global__ void empty() {}

#if BULK
constexpr int BULK_WARPS = 4, BULK_STAGES = 4;

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__global__ void __launch_bounds__(BULK_WARPS * 32) bulk_gather(
    const char* __restrict__ src_re, const char* __restrict__ src_im, char* __restrict__ out_re,
    char* __restrict__ out_im, const int32_t* __restrict__ idx, int64_t n_rows, int64_t n_src,
    int64_t row_bytes, int64_t ld_src, int64_t ld_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[BULK_WARPS][BULK_STAGES];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool two = out_im != nullptr;
  const uint32_t bytes = static_cast<uint32_t>(row_bytes);
  const uint32_t slot_bytes = bytes * (two ? 2 : 1);
  const uint32_t ring = sm90::smem_addr(smem) + warp * BULK_STAGES * slot_bytes;
  if (lane == 0) {
    for (int k = 0; k < BULK_STAGES; ++k) sm90::mbar_init(sm90::smem_addr(&bars[warp][k]), 1);
    sm90::mbar_init_fence();
  }
  __syncwarp();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * BULK_WARPS + warp;
  const int64_t step = static_cast<int64_t>(gridDim.x) * BULK_WARPS;
  // the bulk loads of the j-th row of this warp, into slot j % BULK_STAGES
  auto issue = [&](int64_t j) {
    const int64_t r = first + j * step;
    if (lane != 0 || r >= n_rows) return;
    const int64_t s = idx[r];
    if (s < 0 || s >= n_src) return;
    const int k = static_cast<int>(j % BULK_STAGES);
    const uint32_t bar = sm90::smem_addr(&bars[warp][k]);
    sm90::mbar_arrive_expect_tx(bar, slot_bytes);
    sm90::bulk_copy(ring + k * slot_bytes, src_re + s * ld_src, bytes, bar);
    if (two) sm90::bulk_copy(ring + k * slot_bytes + bytes, src_im + s * ld_src, bytes, bar);
  };
  for (int j = 0; j < BULK_STAGES; ++j) issue(j);
  uint32_t phases = 0;
  for (int64_t j = 0; first + j * step < n_rows; ++j) {
    const int64_t r = first + j * step;
    const int64_t s = idx[r];
    const int k = static_cast<int>(j % BULK_STAGES);
    if (s >= 0 && s < n_src) {
      if (lane == 0) {
        sm90::mbar_wait(sm90::smem_addr(&bars[warp][k]), (phases >> k) & 1u);
        bulk_store(out_re + r * ld_out, ring + k * slot_bytes, bytes);
        if (two) bulk_store(out_im + r * ld_out, ring + k * slot_bytes + bytes, bytes);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the slot is loaded again next: its store must have read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      phases ^= 1u << k;
    } else {
      int4* re = reinterpret_cast<int4*>(out_re + r * ld_out);
      int4* im = two ? reinterpret_cast<int4*>(out_im + r * ld_out) : nullptr;
      for (int64_t c = lane; c < row_bytes / 16; c += 32) {
        re[c] = int4{};
        if (two) im[c] = int4{};
      }
    }
    __syncwarp();
    issue(j + BULK_STAGES);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
#endif

template <typename V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int64_t vec = sizeof(V);
  constexpr int64_t tile = static_cast<int64_t>(THREADS) * UNROLL;
  const int64_t chunks = a.row_bytes / vec;
  int64_t blocks = (a.n_rows * chunks + tile - 1) / tile;
#if PERSISTENT
  static int64_t resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, gather<V>, THREADS, 0);
    resident = static_cast<int64_t>(sms) * per;
  }
  if (blocks > resident) blocks = resident;
#endif
  if (blocks > 2147483647) blocks = 2147483647;
  gather<V><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      reinterpret_cast<const V*>(a.src_re), reinterpret_cast<const V*>(a.src_im),
      reinterpret_cast<V*>(a.out_re), reinterpret_cast<V*>(a.out_im), a.idx, a.n_rows, a.n_src,
      chunks, a.ld_src / vec, a.ld_out / vec);
  return cudaGetLastError();
}

#if BULK
// The bulk route's launch, or cudaErrorNotSupported where it does not apply.
cudaError_t launch_bulk(const Args& a, cudaStream_t stream) {
  const int64_t smem = static_cast<int64_t>(BULK_WARPS) * BULK_STAGES * (a.out_im ? 2 : 1) *
                       a.row_bytes;
  if (a.row_bytes < 1024 || smem > 200 * 1024) return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(bulk_gather, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, bulk_gather, BULK_WARPS * 32, smem);
  int64_t blocks = (a.n_rows + BULK_WARPS - 1) / BULK_WARPS;
  const int64_t resident = static_cast<int64_t>(sms) * (per > 0 ? per : 1);
  if (blocks > resident) blocks = resident;
  bulk_gather<<<static_cast<unsigned>(blocks), BULK_WARPS * 32, smem, stream>>>(
      a.src_re, a.src_im, a.out_re, a.out_im, a.idx, a.n_rows, a.n_src, a.row_bytes, a.ld_src,
      a.ld_out);
  return cudaGetLastError();
}
#endif

int vector_bytes(const Args& a) {
  const uint64_t bits = static_cast<uint64_t>(a.row_bytes) | static_cast<uint64_t>(a.ld_src) |
                        static_cast<uint64_t>(a.ld_out) |
                        reinterpret_cast<uintptr_t>(a.src_re) |
                        reinterpret_cast<uintptr_t>(a.src_im) |
                        reinterpret_cast<uintptr_t>(a.out_re) |
                        reinterpret_cast<uintptr_t>(a.out_im);
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 0;
}

}  // namespace

extern "C" int spfft_row_gather(int dtype, const void* src_re, const void* src_im,
                                void* out_re, void* out_im, const void* idx,
                                int64_t n_rows, int64_t n_src, int64_t width,
                                int64_t ld_src, int64_t ld_out, void* stream) {
  if (n_rows < 1 || width < 1 || n_src < 0 || ld_src < width || ld_out < width ||
      (src_im == nullptr) != (out_im == nullptr) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t item = dtype == 0 ? 4 : 8;
  const Args a{static_cast<const char*>(src_re), static_cast<const char*>(src_im),
               static_cast<char*>(out_re), static_cast<char*>(out_im),
               static_cast<const int32_t*>(idx), n_rows, n_src, width * item, ld_src * item,
               ld_out * item};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#if BULK
  if (vector_bytes(a) == 16) {
    const cudaError_t err = launch_bulk(a, s);
    if (err != cudaErrorNotSupported) return static_cast<int>(err);
  }
#endif
  switch (vector_bytes(a)) {
    case 16: return static_cast<int>(launch<int4>(a, s));
    case 8: return static_cast<int>(launch<int2>(a, s));
    case 4: return static_cast<int>(launch<int>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int k2ab_floor(void* stream) {
  empty<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
# name: (PERSISTENT, UNROLL, DIV32, BULK)
VARIANTS = {
    "flat-u1": (0, 1, 0, 0),
    "flat-u1-div32": (0, 1, 1, 0),
    "flat-u4": (0, 4, 0, 0),
    "persistent-u1": (1, 1, 0, 0),
    "persistent-u2": (1, 2, 0, 0),
    "persistent-u4": (1, 4, 0, 0),
    "bulk-ring": (0, 1, 0, 1),
}
LOCAL_PLANS = ("c2c", "r2c", "c2c-blocked", "r2c-blocked")
MESH_PLANS = ("dist4-c2c", "dist4-r2c", "dist4-c2c-skewed", "dist4-c2c-f64-float")


def build(against) -> dict:
    """Every kernel's library, one ``nvcc`` each, all at once: name -> CDLL."""
    from spfft_tpu_torch import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    source = os.path.join(OUT_DIR, "variants.cu")
    with open(source, "w") as f:
        f.write(VARIANT_SOURCE)
    jobs = {name: ([f"-DPERSISTENT={p}", f"-DUNROLL={u}", f"-DDIV32={d}", f"-DBULK={b}",
                    "-I", str(_build.CSRC)], source)
            for name, (p, u, d, b) in VARIANTS.items()}
    if against:
        csrc = os.path.join(against, "spfft_tpu_torch", "csrc")
        jobs["against"] = (["-I", csrc], os.path.join(csrc, "row_gather.cu"))
    started = {}
    for name, (flags, src) in jobs.items():
        target = os.path.join(OUT_DIR, f"{name}.so")
        started[name] = (target, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", target, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.build_all(cs.LIBRARIES)
    libs = {"this": _build.library("row_gather")}
    for name, (target, proc) in started.items():
        out, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc on {name}:\n{out}")
        libs[name] = ctypes.CDLL(target)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for lib in libs.values():
        lib.spfft_row_gather.argtypes = [ctypes.c_int, p, p, p, p, p, i64, i64, i64, i64, i64, p]
        lib.spfft_row_gather.restype = ctypes.c_int
    libs["flat-u1"].k2ab_floor.argtypes = [p]
    libs["flat-u1"].k2ab_floor.restype = ctypes.c_int
    return libs


def forms(sp):
    """(form name, source planes, index) of every plan in turn; each plan is
    dropped before the next is made."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    local = {p[0]: p for p in cs.PLANS}
    for name in LOCAL_PLANS:
        _, kind, radius, precision, env, _, dtype = local[name]
        triplets = sp.create_spherical_cutoff_triplets(*cs.DIMS, radius,
                                                       hermitian_symmetry=kind == "r2c")
        with cs.knobs(env):
            t = sp.Transform(sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()),
                             *cs.DIMS, indices=triplets, dtype=dtype, precision=precision)
        yield from cs.k2_forms(name, t, gen)
        del t
    mesh = {p[0]: p for p in cs.DIST_PLANS}
    for name in MESH_PLANS:
        _, kind, engine, exchange, dtype, weights, lz, _, _ = mesh[name]
        triplets = sp.create_spherical_cutoff_triplets(*cs.DIMS, 0.659,
                                                       hermitian_symmetry=kind == "r2c")
        per = sp.distribute_triplets(triplets, 4, cs.DIMS[1], weights=weights)
        t = sp.DistributedTransform(
            sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()), *cs.DIMS, per,
            mesh=sp.make_fft_mesh(4), engine=engine,
            exchange_type=getattr(sp.ExchangeType, exchange), dtype=dtype, local_z_lengths=lz)
        yield from ((f, src, idx) for f, src, idx, _ in cs.dist_k2_forms(name, t, gen))
        del t
    from spfft_tpu_torch.programs import benchmark

    for name, argv in cs.BENCH_CONFIGS:
        argv = list(argv)
        argv[argv.index("-r") + 1] = "1"
        with contextlib.redirect_stdout(io.StringIO()):
            report, transforms = benchmark.main(
                [*argv, "-p", "gpu", "-o", os.path.join(OUT_DIR, name + ".json")])
        t = transforms[0]
        if report["results"]["plan"]["kind"] == "distributed":
            yield from ((f, src, idx) for f, src, idx, _ in cs.dist_k2_forms(name, t, gen))
        else:
            yield from cs.k2_forms(name, t, gen)
        del report, transforms, t
        gc.collect()
        torch.cuda.empty_cache()


def time_form(name, src, idx, libs) -> dict:
    """One form's line: every kernel checked, then timed by both clocks."""
    import statistics

    import torch
    from spfft_tpu_torch.ops import row_gather as k2

    src = [t for t in src if t is not None]
    n_src, width = src[0].shape
    n_rows, item, planes = idx.numel(), src[0].element_size(), len(src)
    il = idx.long()
    valid = (il >= 0) & (il < n_src)
    nbytes = (planes * item * width * (torch.unique(il[valid]).numel() + n_rows)
              + idx.element_size() * n_rows)
    copies = cs.l2_copies(planes * item * width * (n_src + n_rows))
    sets = []
    for k in range(copies):
        s = src if k == 0 else [t.clone() for t in src]
        i = idx if k == 0 else idx.clone()
        o = [torch.empty((n_rows, width), dtype=s[0].dtype, device="cuda") for _ in s]
        both = torch.stack([torch.cat([t, t.new_zeros((1, width))]) for t in s])
        li = torch.where(valid, il, torch.full_like(il, n_src))
        sets.append((s, i, o, both, li, both.new_empty((planes, n_rows, width))))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # the capture's, when capturing
    dtype = 0 if item == 4 else 1
    ld_src = src[0].stride(0) if n_src > 1 else width

    def launcher(lib, k):
        s, i, o = sets[k][:3]
        two = planes == 2
        args = (dtype, s[0].data_ptr(), s[1].data_ptr() if two else None, o[0].data_ptr(),
                o[1].data_ptr() if two else None, i.data_ptr(), n_rows, n_src, width, ld_src,
                width)

        def call():
            cs.check(lib.spfft_row_gather(*args, stream()) == 0, f"{name}: launch failed")
        return call

    calls = {kname: [launcher(lib, k) for k in range(copies)] for kname, lib in libs.items()}
    calls["index_select"] = [(lambda b=b, li=li, o=o: torch.index_select(b, 1, li, out=o))
                             for *_, b, li, o in sets]
    floor = libs["flat-u1"].k2ab_floor
    calls["floor"] = [lambda: cs.check(floor(stream()) == 0, "floor launch failed")]
    want = [k2.row_gather_plain(t, idx) for t in src]
    exact = {}
    for kname in libs:
        for o in sets[0][2]:
            o.fill_(float("nan"))
        calls[kname][0]()
        torch.cuda.synchronize()
        exact[kname] = all(torch.equal(g, w) for g, w in zip(sets[0][2], want))
    names = list(calls)
    rounds = {"replay": {n: [] for n in names}, "graph": {n: [] for n in names}}
    for r in range(ROUNDS):
        for n in (names if r % 2 == 0 else names[::-1]):
            rounds["replay"][n].append(cs.device_ms(calls[n][0]))
            rounds["graph"][n].append(cs.graph_ms(calls[n]))
    row = {"form": name, "shape": {"rows": n_rows, "n_src": n_src, "width": width,
                                   "planes": planes, "dtype": str(src[0].dtype).split(".")[1]},
           "vector_bytes": cs.k2_vector_bytes(src, sets[0][2]), "copies": copies,
           "bound_ms": 1e3 * nbytes / cs.PEAK_BYTES, "bitwise_equal": exact}
    for clock, by in rounds.items():
        row[clock] = {"min": {n: min(v) for n, v in by.items()},
                      "median": {n: statistics.median(v) for n, v in by.items()}}
        row[clock]["share"] = {n: row["bound_ms"] / v for n, v in row[clock]["min"].items()
                               if n != "floor"}
    del sets, calls, want
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", default=None, help="another tree, its row_gather.cu timed too")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "k2_ab.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device", file=sys.stderr)
        return 2
    import spfft_tpu_torch as sp

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build(args.against)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    bad = []
    with open(args.out, "w") as out:
        out.write(json.dumps({"card": card, "l2_bytes": l2, "kernels": list(libs)}) + "\n")
        for name, src, idx in forms(sp):
            row = time_form(name, src, idx, libs)
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
            bad += [f"{name}:{k}" for k, ok in row["bitwise_equal"].items() if not ok]
            del src, idx
    cs.check(not bad, f"not bitwise equal to the plain version: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
