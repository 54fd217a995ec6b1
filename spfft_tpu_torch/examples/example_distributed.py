"""Distributed spfft_tpu_torch example: a 4-shard mesh transform from Python.

The twin of the JAX package's ``examples/example_distributed.py``. One
process drives every shard of the mesh (the reference's per-rank MPI arrays
become per-shard lists); the four shards sit stacked on the CUDA card
(``make_fft_mesh(4)``), or on the CPU with ``--device cpu``. Demonstrates the
plan flow, the round trip, and the exchange-discipline accounting
(``exchange_wire_bytes`` / ``exchange_rounds``) that guides the BUFFERED /
COMPACT_BUFFERED / UNBUFFERED choice. Without a card and without
``--device cpu`` it raises ``GPUNoDeviceError``.

    python -m spfft_tpu_torch.examples.example_distributed
    python -m spfft_tpu_torch.examples.example_distributed --device cpu
"""
import argparse

import numpy as np

import spfft_tpu_torch as sp
from spfft_tpu_torch import (
    DistributedTransform,
    ExchangeType,
    ProcessingUnit,
    ScalingType,
    TransformType,
    distribute_triplets,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    args = ap.parse_args(argv)
    pu = ProcessingUnit.HOST if args.device == "cpu" else ProcessingUnit.GPU
    dim = 16
    num_shards = 4

    # raises GPUNoDeviceError without a card
    mesh = sp.make_fft_mesh(num_shards, device="cpu" if args.device == "cpu" else None)

    # Frequency-domain triplets inside a spherical cutoff (plane-wave style),
    # partitioned by whole z-sticks: every (x, y) column lives on one shard.
    triplets = sp.create_spherical_cutoff_triplets(dim, dim, dim, 0.7)
    per_shard = distribute_triplets(triplets, num_shards, dim)

    rng = np.random.default_rng(0)
    values = [rng.standard_normal(len(p)) + 1j * rng.standard_normal(len(p)) for p in per_shard]

    errors = {}
    for exchange in (ExchangeType.BUFFERED, ExchangeType.COMPACT_BUFFERED,
                     ExchangeType.UNBUFFERED):
        t = DistributedTransform(pu, TransformType.C2C, dim, dim, dim,
                                 [p.copy() for p in per_shard], mesh=mesh,
                                 exchange_type=exchange, dtype=np.dtype(args.dtype))
        space = t.backward([v.copy() for v in values])  # global (Z, Y, X)
        back = t.forward(scaling=ScalingType.FULL)  # per-shard value lists
        err = max(float(np.abs(b.cpu().numpy() - v).max()) for b, v in zip(back, values))
        errors[exchange.name] = err
        print(f"{exchange.name:16s} roundtrip {err:.2e}  "
              f"wire {t.exchange_wire_bytes():>8,} B  rounds {t.exchange_rounds()}")
        assert err < 1e-4  # float32 (--dtype float64 reads about 1e-15)
    print("space domain shape:", tuple(space.shape))
    return {"roundtrip_errors": errors}


if __name__ == "__main__":
    main()
