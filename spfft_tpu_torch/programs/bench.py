"""The one-line benchmark, the port of the JAX package's ``bench.py``: prints ONE
JSON line.

The headline configuration: 256^3 C2C inside the ~15 % spherical cutoff
(radius 0.659), float32, backward + forward(FULL) on the CUDA card, as GFLOP/s
from the ``5 N log2 N`` flop model per 3-D transform, two per pair. The pair
time is :func:`spfft_tpu_torch.obs.perf.measure_pair_seconds`: ``CHAIN``
dependent pairs per repeat, best of three, each repeat timed by the host
clock up to the completion fence. ``vs_baseline`` is the JAX package's
definition: a dense ``numpy.fft`` pair on the same grid in the same process
(best of three) over the pair time. The line embeds the plan card, the perf
report and the run ID.

    python -m spfft_tpu_torch.programs.bench            # on the card
    python -m spfft_tpu_torch.programs.bench --cpu --dim 32   # CPU smoke

``--cpu`` runs the same measurement on a CPU plan (the ``torch.fft`` engine);
its line says ``"platform": "cpu"`` and is no device figure.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

CHAIN = 16
RADIUS = 0.659  # ~15 % of the grid inside the sphere


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--cpu", action="store_true", help="a CPU plan (no device figure)")
    args = ap.parse_args(argv)

    import spfft_tpu_torch as sp
    from spfft_tpu_torch import obs

    dim = args.dim
    pu = sp.ProcessingUnit.HOST if args.cpu else sp.ProcessingUnit.GPU
    triplets = sp.create_spherical_cutoff_triplets(dim, dim, dim, RADIUS)
    t = sp.Transform(pu, sp.TransformType.C2C, dim, dim, dim, indices=triplets,
                     dtype=np.float32)
    measured = obs.perf.measure_pair_seconds(t, chain=args.chain, repeats=3)
    best = measured["seconds_per_pair"]
    err = measured["roundtrip_residual"]
    if not err < 1e-2:
        raise RuntimeError(f"roundtrip chain diverged: {err}")
    ntot = dim ** 3
    gflops = 2 * 5.0 * ntot * np.log2(ntot) / best / 1e9

    rng = np.random.default_rng(0)
    dense = (rng.standard_normal((dim,) * 3)
             + 1j * rng.standard_normal((dim,) * 3)).astype(np.complex64)
    dense_time = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.fft.fftn(np.fft.ifftn(dense))
        dense_time = min(dense_time, time.perf_counter() - t0)

    card = t.report()
    perf = obs.perf.perf_report(t, best, repeats=3)
    line = {
        "metric": f"c2c_{dim}_sparse15pct_fwd_bwd_gflops",
        "value": round(gflops, 2),
        "unit": "GFLOP/s",
        "vs_baseline": round(dense_time / best, 3),
        "platform": card["platform"],
        "plan": card,
        "perf": perf,
        "device_count": perf["device_count"],
        "run_id": card["run_id"],
        "fused": t.fused,
        "verify_mode": card["verification"]["mode"],
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
