"""Multi-process smoke run: one rank of a distributed transform over a group.

The port of ``programs/multihost_smoke.py``. Each process holds one shard of
an N-shard slab mesh joined over a ``torch.distributed`` group on gloo (the
CPU stand-in for the reference's ``mpirun -n 2`` CI). All ranks build the
same seeded global plan, supply values for their OWN shard only, run
backward + forward through the public entry points, and check their local
slab against a dense oracle and the value round trip. Prints
``RANK <r> PASS`` on success.

NCCL refuses two ranks on one card, so this program runs on the CPU; on the
card it needs as many cards as ranks (ROADMAP item 5b). ``overlap_chunks >
1`` runs the OVERLAPPED exchange: C chunk collectives a direction, each
issued asynchronously and waited on by its unpack.

    python -m spfft_tpu_torch.programs.multihost_smoke <rank> <port> <engine>
        [c2c|r2c] [buffered|compact|unbuffered] [nprocs] [overlap_chunks]
"""
from __future__ import annotations

import sys

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    rank, port, engine = int(argv[0]), int(argv[1]), argv[2]
    ttype_name = argv[3] if len(argv) > 3 else "c2c"
    exchange_name = argv[4] if len(argv) > 4 else "buffered"
    nprocs = int(argv[5]) if len(argv) > 5 else 2
    overlap = int(argv[6]) if len(argv) > 6 else 1

    import torch.distributed as dist

    import spfft_tpu_torch as sp
    from spfft_tpu_torch import (
        DistributedTransform,
        ExchangeType,
        ProcessingUnit,
        ScalingType,
        TransformType,
    )

    group = sp.init_distributed(f"localhost:{port}", nprocs, rank, backend="gloo")
    try:
        assert dist.get_world_size() == nprocs
        mesh = sp.make_fft_mesh(1, device="cpu", group=group)

        dx, dy, dz = 8, 9, 10
        rng = np.random.default_rng(42)  # same seed on every rank: one global plan
        r2c = ttype_name == "r2c"
        if r2c:
            # the full half-spectrum of a real field: real output, exact round trip
            real_field = rng.standard_normal((dz, dy, dx))
            full = np.fft.fftn(real_field) / (dx * dy * dz)
            xs = np.arange(dx // 2 + 1)
            triplets = np.stack(
                np.meshgrid(xs, np.arange(dy), np.arange(dz), indexing="ij"), -1
            ).reshape(-1, 3)
            values = full[triplets[:, 2], triplets[:, 1], triplets[:, 0]]
        else:
            xs, ys = np.meshgrid(np.arange(dx), np.arange(dy), indexing="ij")
            keys = np.stack([xs.ravel(), ys.ravel()], axis=1)
            chosen = keys[rng.choice(len(keys), size=len(keys) // 2, replace=False)]
            triplets = np.asarray([(x, y, z) for x, y in chosen for z in range(dz)])
            values = rng.standard_normal(len(triplets)) + 1j * rng.standard_normal(len(triplets))
        per_shard = [np.asarray(t) for t in sp.distribute_triplets(triplets, nprocs, dy)]
        lut = {tuple(t): v for t, v in zip(map(tuple, triplets), values)}
        values_per_shard = [np.asarray([lut[tuple(t)] for t in trip]) for trip in per_shard]

        t = DistributedTransform(
            ProcessingUnit.HOST,
            TransformType.R2C if r2c else TransformType.C2C,
            dx, dy, dz, per_shard, mesh=mesh,
            exchange_type={
                "compact": ExchangeType.COMPACT_BUFFERED,
                "unbuffered": ExchangeType.UNBUFFERED,
            }.get(exchange_name, ExchangeType.BUFFERED),
            engine=engine, overlap=overlap,
        )
        mine = set(mesh.local_shards)
        supplied = [v if r in mine else None for r, v in enumerate(values_per_shard)]

        if r2c:
            oracle = real_field
        else:
            dense = np.zeros((dz, dy, dx), dtype=np.complex128)
            dense[triplets[:, 2] % dz, triplets[:, 1] % dy, triplets[:, 0] % dx] = values
            oracle = np.fft.ifftn(dense) * (dx * dy * dz)

        # the public host-facing path: backward returns this process's slabs,
        # forward reuses the retained space
        slabs = t.backward(supplied)
        for r in range(nprocs):
            if r not in mine:
                assert slabs[r] is None, f"rank {rank} got shard {r}'s slab"
                continue
            o, n = t.local_z_offset(r), t.local_z_length(r)
            err = np.abs(slabs[r].numpy() - oracle[o:o + n]).max()
            assert err < 1e-6, f"rank {rank} slab err {err}"
        back = t.forward(scaling=ScalingType.FULL)
        for r in mine:
            err = np.abs(back[r].numpy() - values_per_shard[r]).max()
            assert err < 1e-6, f"rank {rank} shard {r} roundtrip err {err}"
    finally:
        dist.destroy_process_group()
    print(f"RANK {rank} PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
