"""What the programs of the port share: the ``--device`` flag (the card
unless the caller asks for the CPU, never a fallback), ``--radius`` and
``--dtype``, and seeded frequency values of a plan's shape."""
from __future__ import annotations


def add_device_flag(ap) -> None:
    ap.add_argument("--device", choices=["gpu", "cpu"], default="gpu",
                    help="where the plans run: the CUDA card (default) or the CPU")


def processing_unit(device: str):
    """The processing unit of ``--device``; ``gpu`` without a CUDA device
    raises :class:`~spfft_tpu_torch.errors.GPUNoDeviceError` here, before
    any work: nothing falls back to the CPU."""
    import spfft_tpu_torch as sp

    pu = sp.ProcessingUnit.HOST if device == "cpu" else sp.ProcessingUnit.GPU
    sp.device_for_processing_unit(pu)
    return pu


def mesh_device(device: str):
    """The ``device=`` of ``make_fft_mesh``/``make_fft_mesh2`` for ``--device``
    (None: the current CUDA device)."""
    return "cpu" if device == "cpu" else None


def random_values(plan, rng, distributed: bool):
    """Seeded complex frequency values of ``plan``'s shape: one array, or a
    list per shard, as the JAX programs draw them."""
    if distributed:
        return [rng.standard_normal(plan.num_local_elements(r))
                + 1j * rng.standard_normal(plan.num_local_elements(r))
                for r in range(plan.num_shards)]
    n = plan.num_local_elements
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def add_radius_flag(ap) -> None:
    ap.add_argument("--radius", type=float, default=None,
                    help="spherical cutoff radius, as a fraction of the half extent "
                    "(overrides -s; 0.659 holds about 15 %% of the grid)")


def cutoff_radius(args) -> float:
    """``--radius``, else the radius that holds ``-s`` of the grid (at most 1)."""
    import spfft_tpu_torch as sp

    if args.radius is not None:
        return args.radius
    return min(sp.spherical_radius_for_fraction(args.s), 1.0)


def add_dtype_flag(ap) -> None:
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="the plan's real dtype (default: the package's, float64)")
