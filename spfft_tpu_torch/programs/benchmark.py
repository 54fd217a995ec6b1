"""Benchmark CLI: the reference's ``benchmark`` program (reference:
tests/programs/benchmark.cpp), the port of the JAX package's
``programs/benchmark.py``.

The same flags (``-d X Y Z -r repeats -o out.json -s sparsity -t c2c|r2c
-e exchange -p cpu|gpu -m numTransforms``, ``--shards``, ``--precision``,
``--model``, ``--engine``, ``--matmul-precision``), the same stick models
(``xslab``: every (x, y) with x < dimXFreq * s, the R2C x == 0 sticks only
y < dimYFreq, split contiguously over the shards, reference:
benchmark.cpp:177-205; ``spherical``: the centred sphere holding a fraction s
of the grid, its sticks split by :func:`~spfft_tpu_torch.distribute_triplets`),
a warm-up, then ``r`` timed dependent backward+forward(FULL) pairs, the
forward output feeding the next backward, and a JSON report of
``parameters``, ``results`` (pair time, GFLOP/s from ``5 N log2 N`` per
transform, two per pair, the plan card) and ``timings`` (the timing tree).

``-p gpu`` runs on the CUDA card and raises :class:`GPUNoDeviceError` where
there is none; ``--shards N`` stacks N shards on the one card
(``make_fft_mesh(N)``). The pairs are timed by the host clock from the first
dispatch to the completion fence after the last pair: the JAX package chains
them inside one jitted ``lax.scan``, and here each pair is two host calls (on
a fused plan two CUDA-graph replays), so the host's cost per pair is part of
the figure. ``results`` adds ``roundtrip_residual``: one backward +
forward(FULL) of the inputs against them, max abs difference over max abs
value (the pair is the identity; the R2C values are hermitian-consistent).
``--mesh2 P1 P2`` runs the 2-D pencil decomposition over a ``(P1, P2)``
mesh (``make_fft_mesh2``, P1 * P2 shards stacked on the card) with the
padded disciplines only, as the JAX program: ``-e`` takes ``buffered``,
``bufferedFloat`` or ``bufferedBF16``, and ``all`` sweeps those.

    python -m spfft_tpu_torch.programs.benchmark -d 32 32 32 -r 10 -p cpu -o out.json
    python -m spfft_tpu_torch.programs.benchmark -d 512 512 512 -r 4 -t r2c \\
        --model spherical -s 0.15 --shards 16 -p gpu --precision double -o out.json
    python -m spfft_tpu_torch.programs.benchmark -d 512 512 512 -r 4 -t r2c \\
        --model spherical -s 0.15 --mesh2 4 4 -p gpu -o out.json
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

EXCHANGE_NAMES = {
    "buffered": "BUFFERED",
    "bufferedFloat": "BUFFERED_FLOAT",
    "compact": "COMPACT_BUFFERED",
    "compactFloat": "COMPACT_BUFFERED_FLOAT",
    "unbuffered": "UNBUFFERED",
    "bufferedBF16": "BUFFERED_BF16",
    "compactBF16": "COMPACT_BUFFERED_BF16",
}
# the -e names a --mesh2 run takes, as the JAX program's
PENCIL_EXCHANGES = ("buffered", "bufferedBF16", "bufferedFloat")
def create_benchmark_triplets(dim_x, dim_y, dim_z, sparsity, r2c):
    """The reference benchmark's stick set (reference: benchmark.cpp:177-205):
    all (x, y) with x < dimXFreq*sparsity; for R2C, the x==0 sticks cover only
    y < dimYFreq (hermitian non-redundant half). Returns the triplets and the
    stick count."""
    dim_x_freq = dim_x // 2 + 1 if r2c else dim_x
    dim_y_freq = dim_y // 2 + 1 if r2c else dim_y
    xs = np.arange(int(np.ceil(dim_x_freq * sparsity)) or 1, dtype=np.int32)
    xy = np.concatenate([
        np.stack([np.full(dim_y_freq if x == 0 else dim_y, x, dtype=np.int32),
                  np.arange(dim_y_freq if x == 0 else dim_y, dtype=np.int32)], axis=1)
        for x in xs
    ])
    trips = np.empty((len(xy), dim_z, 3), dtype=np.int32)
    trips[:, :, 0] = xy[:, None, 0]
    trips[:, :, 1] = xy[:, None, 1]
    trips[:, :, 2] = np.arange(dim_z, dtype=np.int32)[None, :]
    return trips.reshape(-1, 3), len(xy)


def split_contiguous(triplets, num_sticks, num_shards, dim_z):
    """Even contiguous stick distribution over shards (reference: benchmark.cpp:190-205)."""
    per = [num_sticks // num_shards + (1 if r < num_sticks % num_shards else 0)
           for r in range(num_shards)]
    out, pos = [], 0
    for n in per:
        out.append(triplets[pos * dim_z:(pos + n) * dim_z])
        pos += n
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="sparse 3D FFT benchmark (PyTorch port)")
    ap.add_argument("-d", nargs=3, type=int, required=True, metavar=("X", "Y", "Z"))
    ap.add_argument("-r", type=int, required=True, help="number of repeats")
    ap.add_argument("-o", type=str, required=True, help="output JSON file")
    ap.add_argument("-m", type=int, default=1, help="multiple transform number")
    ap.add_argument("-s", type=float, default=1.0, help="sparsity")
    ap.add_argument("-t", choices=["c2c", "r2c"], default="c2c")
    ap.add_argument("-e", choices=sorted(EXCHANGE_NAMES) + ["all"], default="buffered",
                    help="exchange type (distributed runs)")
    ap.add_argument("-p", choices=["cpu", "gpu", "gpu-gpu"], required=True)
    ap.add_argument("--shards", type=int, default=1, help="mesh size (1 = local)")
    ap.add_argument("--mesh2", nargs=2, type=int, default=None, metavar=("P1", "P2"),
                    help="2-D pencil mesh factors (P1 * P2 shards; -e buffered variants only)")
    ap.add_argument("--precision", choices=["single", "double"], default=None,
                    help="default: double on cpu, single on the card")
    ap.add_argument("--engine", choices=["auto", "mxu", "xla"], default="auto",
                    help="local execution engine (default: auto-select)")
    ap.add_argument("--model", choices=["xslab", "spherical"], default="xslab",
                    help="stick model: xslab = reference benchmark's x < Xf*s slab "
                    "(benchmark.cpp:177-205); spherical = centered spherical cutoff with "
                    "nonzero fraction ~= s (the plane-wave DFT workload)")
    ap.add_argument("--matmul-precision", choices=["highest", "high"], default="highest",
                    help="accelerator engine matmul precision")
    args = ap.parse_args(argv)
    if args.mesh2 is not None:
        p1, p2 = args.mesh2
        if p1 < 1 or p2 < 1 or p1 * p2 < 2:
            ap.error("--mesh2 factors must be >= 1 with product >= 2")
        args.shards = p1 * p2
        # the JAX program's pencil sweep: the padded disciplines
        if args.e not in PENCIL_EXCHANGES + ("all",):
            ap.error(f"--mesh2 supports only {list(PENCIL_EXCHANGES)} for -e")
    return args


def main(argv=None):
    """Run the benchmark, write the report to ``-o``, print its parameters
    and results; returns ``(report, transforms)``, the plans of the first
    exchange of the sweep (for callers that profile them further)."""
    args = parse_args(argv)
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import timing
    from spfft_tpu_torch.parameters import stick_keys
    from spfft_tpu_torch.sync import fence

    if args.precision == "double" or (args.precision is None and args.p == "cpu"):
        dtype = np.float64
    else:
        dtype = np.float32
    on_card = args.p != "cpu"
    pu = sp.ProcessingUnit.GPU if on_card else sp.ProcessingUnit.HOST
    if on_card:  # raises GPUNoDeviceError without a card: no fallback
        sp.device_for_processing_unit(pu)
    dim_x, dim_y, dim_z = args.d
    r2c = args.t == "r2c"
    ttype = sp.TransformType.R2C if r2c else sp.TransformType.C2C
    if args.mesh2 is not None:
        exchange_sweep = list(PENCIL_EXCHANGES) if args.e == "all" else [args.e]
    elif args.shards > 1:
        exchange_sweep = sorted(EXCHANGE_NAMES) if args.e == "all" else [args.e]
    else:
        exchange_sweep = [args.e if args.e != "all" else "buffered"]

    if args.model == "spherical":
        radius = sp.spherical_radius_for_fraction(args.s)
        if radius > 1.0:
            print(f"note: -s {args.s} exceeds the inscribed ball (pi/6); clipping")
        triplets = sp.create_spherical_cutoff_triplets(dim_x, dim_y, dim_z, radius,
                                                       hermitian_symmetry=r2c)
        num_sticks = len(np.unique(stick_keys(triplets, dim_y)))
    else:
        triplets, num_sticks = create_benchmark_triplets(dim_x, dim_y, dim_z, args.s, r2c)
    rng = np.random.default_rng(42)

    def build_transforms(exchange_name):
        exchange = sp.ExchangeType[EXCHANGE_NAMES[exchange_name]]
        with timing.scoped("Grid + Transform init"):
            if args.shards > 1:
                device = None if on_card else "cpu"
                mesh = (sp.make_fft_mesh2(*args.mesh2, device=device) if args.mesh2 is not None
                        else sp.make_fft_mesh(args.shards, device=device))
                if args.model == "spherical":
                    per_shard = sp.distribute_triplets(triplets, args.shards, dim_y)
                else:
                    per_shard = split_contiguous(triplets, num_sticks, args.shards, dim_z)
                return [sp.DistributedTransform(
                    pu, ttype, dim_x, dim_y, dim_z, [np.asarray(t) for t in per_shard],
                    mesh=mesh, exchange_type=exchange, dtype=dtype, engine=args.engine,
                    precision=args.matmul_precision) for _ in range(args.m)]
            return [sp.Transform(pu, ttype, dim_x, dim_y, dim_z, indices=triplets, dtype=dtype,
                                 engine=args.engine, precision=args.matmul_precision)
                    for _ in range(args.m)]

    def make_values(t):
        if r2c:  # hermitian-consistent inputs: derive from a real field
            return t.forward(rng.standard_normal((dim_z, dim_y, dim_x)), sp.ScalingType.NONE)
        if args.shards > 1:
            return [rng.standard_normal(t.num_local_elements(r))
                    + 1j * rng.standard_normal(t.num_local_elements(r))
                    for r in range(t.num_shards)]
        n = t.num_local_elements
        return rng.standard_normal(n) + 1j * rng.standard_normal(n)

    def measure(exchange_name):
        transforms = build_transforms(exchange_name)
        values = [make_values(t) for t in transforms]
        # warm-up (reference: benchmark.cpp:63-70)
        with timing.scoped("warmup"):
            sp.multi_transform_backward(transforms, values)
            sp.multi_transform_forward(transforms, None, sp.ScalingType.FULL)
        pairs = [t._exec.pad_values(v) if args.shards > 1 else t._exec.values_pair(v)
                 for t, v in zip(transforms, values)]

        def chain():
            """``r`` dependent pairs of every transform (reference:
            benchmark.cpp:84-96), ending in the completion fence."""
            outs = list(pairs)
            for _ in range(args.r):
                for i, t in enumerate(transforms):
                    t.backward_pair(*outs[i])
                    outs[i] = t.forward_pair(sp.ScalingType.FULL)
            return fence(outs)

        # the exact timed work once untimed: CUDA-graph captures, the kernels'
        # libraries, cuFFT plans
        with timing.scoped("warmup chain"):
            chain()
        with timing.scoped("benchmark loop"):
            start = time.perf_counter()
            chain()
            elapsed = time.perf_counter() - start
        # one round trip from the inputs: the transform's accuracy (the timed
        # chain's last values carry the rounding of every pair before them)
        residual = 0.0
        for t, p in zip(transforms, pairs):
            t.backward_pair(*p)
            back = torch.complex(*t.forward_pair(sp.ScalingType.FULL))
            want = torch.complex(*p)
            residual = max(residual, float(torch.abs(back - want).max() / torch.abs(want).max()))
        pair_seconds = elapsed / (args.r * args.m)
        n_total = dim_x * dim_y * dim_z
        flops = 2 * 5.0 * n_total * np.log2(n_total)  # 5 N log2 N per transform, two per pair
        out = {
            "wall_s_total": elapsed,
            "wall_s_per_transform_pair": pair_seconds,
            "gflops_per_pair": flops / pair_seconds / 1e9,
            "plan": transforms[0].report(),
            # how the plan's decisions were made (tuning.wisdom_state)
            "wisdom": sp.tuning.wisdom_state(transforms[0]),
            "roundtrip_residual": residual,
        }
        if args.shards > 1:
            out["exchange_wire_bytes"] = transforms[0].exchange_wire_bytes()
        return out, transforms

    was_timing = timing.is_enabled()
    timing.clear()
    timing.enable()
    try:
        measured = {name: measure(name) for name in exchange_sweep}
        results = {name: m[0] for name, m in measured.items()}
        report = {
            "parameters": {
                "dim_x": dim_x, "dim_y": dim_y, "dim_z": dim_z,
                "sparsity": args.s,
                "effective_nnz_fraction": float(len(triplets) / (dim_x * dim_y * dim_z)),
                "num_z_sticks": int(num_sticks),
                "num_elements": int(len(triplets)),
                "transform_type": args.t,
                "processing_unit": args.p,
                "exchange": exchange_sweep if len(exchange_sweep) > 1 else exchange_sweep[0],
                "precision": "double" if dtype == np.float64 else "single",
                "num_transforms": args.m,
                "repeats": args.r,
                "shards": args.shards,
                "mesh2": args.mesh2,
                "backend": "gpu" if on_card else "cpu",
                "device": torch.cuda.get_device_name() if on_card else "cpu",
            },
            "results": (results[exchange_sweep[0]] if len(exchange_sweep) == 1 else results),
            "timings": timing.process().to_dict(),
        }
    finally:
        if not was_timing:
            timing.disable()
    Path(args.o).write_text(json.dumps(report, indent=2))
    print(json.dumps({k: report[k] for k in ("parameters", "results")}, indent=2))
    return report, measured[exchange_sweep[0]][1]


if __name__ == "__main__":
    main()
