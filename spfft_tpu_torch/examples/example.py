"""Minimal spfft_tpu_torch usage example: the reference example flow in Python.

The twin of the JAX package's ``examples/example.py`` (the reference's
examples/example.cpp): build the frequency-domain index triplets of a small
grid, create a Grid and a Transform bound to it, run a backward transform
(freq -> space), inspect the space-domain data, then transform forward with
scaling and recover the input values. It runs on the CUDA card
(``ProcessingUnit.GPU``) unless ``--device cpu`` is given; without a card
it raises ``GPUNoDeviceError``.

    python -m spfft_tpu_torch.examples.example              # on the card
    python -m spfft_tpu_torch.examples.example --device cpu
"""
import argparse

import numpy as np

import spfft_tpu_torch as sp
from spfft_tpu_torch import Grid, ProcessingUnit, ScalingType, TransformType


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    args = ap.parse_args(argv)
    pu = ProcessingUnit.HOST if args.device == "cpu" else ProcessingUnit.GPU
    sp.device_for_processing_unit(pu)  # GPUNoDeviceError without a card
    dim_x = dim_y = dim_z = 4

    # Frequency-domain triplets: every (x, y, z) of the dense grid (a real
    # application supplies only the indices inside its energy cutoff; see
    # sp.create_spherical_cutoff_triplets).
    indices = np.stack(
        np.meshgrid(np.arange(dim_x), np.arange(dim_y), np.arange(dim_z), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)

    # A Grid declares the maxima of the transforms it hands out; processing
    # unit HOST = the CPU, GPU = the CUDA card.
    grid = Grid(dim_x, dim_y, dim_z, max_num_local_z_columns=dim_x * dim_y,
                processing_unit=pu)
    transform = grid.create_transform(pu, TransformType.C2C, dim_x, dim_y, dim_z,
                                      indices=indices, dtype=np.dtype(args.dtype))

    rng = np.random.default_rng(0)
    n = len(indices)
    values = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    print(f"input frequency values ({n} elements), first 4: {values[:4]}")

    space = transform.backward(values).cpu().numpy()  # (dim_z, dim_y, dim_x)
    print(f"space domain shape: {space.shape}, dtype: {space.dtype}")
    print(f"space_domain_data()[0, 0, :4]: {transform.space_domain_data()[0, 0, :4]}")

    roundtrip = transform.forward(scaling=ScalingType.FULL).cpu().numpy()
    err = float(np.abs(roundtrip - values).max())
    print(f"max roundtrip error: {err:.2e}")
    return {"space": space, "roundtrip_error": err}


if __name__ == "__main__":
    main()
