"""Plane-wave Poisson solver on a sparse frequency sphere: the workload class
SpFFT was built for (SIRIUS-style plane-wave DFT codes; reference: README.md:8).

The twin of the JAX package's ``examples/poisson.py``. Solves the periodic
Poisson equation  -lap(phi) = rho  on an N^3 box: the charge density rho
lives on the real-space grid; its spectrum is truncated to a spherical
cutoff |G| <= G_max (the plane-wave basis), where the equation diagonalizes:
phi_hat(G) = rho_hat(G) / |G|^2 (phi_hat(0) = 0 fixes the gauge for a
neutral cell). Only the inside-cutoff coefficients are ever stored or
transformed: the sparse-frequency contract of the library. It runs on the
CUDA card unless ``--device cpu`` is given; without a card it raises
``GPUNoDeviceError`` (nothing falls back to the CPU).

    python -m spfft_tpu_torch.examples.poisson
    python -m spfft_tpu_torch.examples.poisson --device cpu --dtype float64
"""
import argparse

import numpy as np

import spfft_tpu_torch as sp
from spfft_tpu_torch import ProcessingUnit, ScalingType, Transform, TransformType


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    args = ap.parse_args(argv)
    pu = ProcessingUnit.HOST if args.device == "cpu" else ProcessingUnit.GPU
    sp.device_for_processing_unit(pu)  # GPUNoDeviceError without a card
    n = 48
    box = 2 * np.pi  # cubic cell, side length 2*pi -> G vectors are integers

    # Plane-wave basis: all G triplets inside the cutoff sphere (centered
    # indexing: negative frequencies as negative integers).
    g_max = n // 4
    trip = sp.create_spherical_cutoff_triplets(n, n, n, 2 * g_max / n)
    g = trip.astype(np.float64) * (2 * np.pi / box)
    g2 = (g**2).sum(axis=1)

    t = Transform(pu, TransformType.C2C, n, n, n, indices=trip, dtype=np.dtype(args.dtype))

    # A neutral charge density: two opposite Gaussian blobs.
    zyx = np.stack(np.meshgrid(*([np.arange(n) * (box / n)] * 3), indexing="ij"), axis=-1)

    def blob(center, sign, width=0.35):
        d = zyx - np.asarray(center)
        d -= box * np.round(d / box)  # minimum-image (periodic)
        return sign * np.exp(-(d**2).sum(-1) / (2 * width**2))

    rho = blob((2.0, 2.0, 2.0), +1.0) + blob((4.5, 4.0, 3.0), -1.0)
    rho -= rho.mean()  # enforce neutrality exactly

    # forward: real space -> sparse plane-wave coefficients (scaled DFT)
    rho_hat = t.forward(rho.astype(np.complex128), scaling=ScalingType.FULL).cpu().numpy()

    # solve in the plane-wave basis
    phi_hat = np.where(g2 > 0, rho_hat / np.maximum(g2, 1e-300), 0.0)

    # backward: coefficients -> potential on the grid
    phi = t.backward(phi_hat).real.cpu().numpy()

    # residual of the PDE, evaluated spectrally on the SAME sparse basis
    lap_hat = t.forward(phi.astype(np.complex128),
                        scaling=ScalingType.FULL).cpu().numpy() * g2
    mask = g2 > 0
    res = np.abs(lap_hat[mask] - rho_hat[mask]).max() / np.abs(rho_hat[mask]).max()

    print(f"plane-wave basis size: {len(trip)} of {n**3} grid points "
          f"({100 * len(trip) / n**3:.1f}%)")
    print(f"potential range: [{phi.min():.4f}, {phi.max():.4f}]")
    print(f"spectral residual |G^2 phi - rho| / |rho|: {res:.2e}")
    # the spectral residual amplifies the transform's round trip by |G|^2
    # (up to ~430 here): a few 1e-6 in float32
    assert res < 1e-5, "Poisson solve failed"
    print("OK")
    return {"residual": float(res), "phi_range": (float(phi.min()), float(phi.max()))}


if __name__ == "__main__":
    main()
